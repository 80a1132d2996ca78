"""``python -m squeezellm_tpu_torch``: see :mod:`squeezellm_tpu_torch.cli`."""

from squeezellm_tpu_torch.cli import main

if __name__ == "__main__":
    main()
