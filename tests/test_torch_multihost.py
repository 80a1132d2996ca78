"""`parallel/multihost.py` of the port, the counterpart of
tests/test_multihost.py:

* in one process: `initialize` is a no-op without a multi-process
  environment and with a size of 1, `is_primary` holds, a tp that does
  not divide the ranks is refused, and the backend rule
  (`backend_for`, `rank_device`) on the CPU and on a CUDA device;
* four launched ranks (gloo, a file rendezvous under tmp_path): the
  ('dp', 'tp') mesh's shape and axis order, consecutive ranks a tp group,
  all-reduces over the world and over each tp group, rank 0 primary and
  the others not, and the lm_head's vocab gather in both of its forms
  (NCCL's all-gather and gloo's all-reduce of zero-filled rows, here both
  over gloo on the CPU) putting each rank's block in its place;
* the launcher fails rather than waits: a rank that raises (its
  traceback in the error), one that exits without reporting, and ranks
  that outlast the join timeout.
"""

import pytest
import torch

from squeezellm_tpu_torch.parallel import multihost
import torch_tp_workers as workers

JOIN_S = 120


def test_initialize_single_process_noop(monkeypatch):
    for var in ("WORLD_SIZE", "SLURM_NTASKS"):
        monkeypatch.delenv(var, raising=False)
    multihost.initialize()
    multihost.initialize(world_size=1)
    monkeypatch.setenv("WORLD_SIZE", "1")
    multihost.initialize()
    assert not torch.distributed.is_initialized()
    assert multihost.is_primary()


def test_pod_mesh_rejects_indivisible():
    with pytest.raises(ValueError, match="not divisible"):
        multihost.pod_mesh(tp=3)


def test_backend_rule(monkeypatch):
    assert multihost.backend_for("cpu", 2) == "gloo"
    assert multihost.rank_device("cpu", 1, "gloo") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    # ranks sharing one card: gloo, every rank on card 0
    assert multihost.backend_for("cuda", 2) == "gloo"
    assert multihost.rank_device("cuda", 1, "gloo") == torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    # a card a rank: NCCL, rank r on card r
    assert multihost.backend_for("cuda", 4) == "nccl"
    assert multihost.rank_device("cuda", 3, "nccl") == torch.device("cuda", 3)


def test_four_ranks_pod_mesh_and_all_reduce(tmp_path):
    out = multihost.launch(workers.mesh_worker, 4,
                           init_file=str(tmp_path / "rendezvous"),
                           join_timeout_s=JOIN_S)
    for rank, r in enumerate(out):
        assert r["shape"] == (2, 2) and r["names"] == ("dp", "tp")
        assert r["coord"] == (rank // 2, rank % 2)
        assert r["tp_ranks"] == [rank // 2 * 2, rank // 2 * 2 + 1]
        assert r["primary"] == (rank == 0) and r["refused"]
        assert r["world_sum"] == [10.0, 10.0]
        assert r["tp_sum"] == (3.0 if rank < 2 else 7.0)
        # each rank's (2, 1, 6) block side by side on the last axis
        want = torch.cat([torch.arange(12.0).reshape(2, 1, 6) + 100 * q
                          for q in range(4)], -1).tolist()
        assert r["gathered"] == [want, want]


@pytest.mark.parametrize("how,match", [
    ("raise", "(?s)rank 1 failed:.*rank failed on purpose"),
    ("exit", "rank 1 exited with code 0 and reported nothing"),
    ("sleep", r"did not finish in 8 s")])
def test_launcher_fails_instead_of_waiting(tmp_path, how, match):
    with pytest.raises(RuntimeError, match=match):
        multihost.launch(workers.fail_on, 2, args=(1, how),
                         init_file=str(tmp_path / "rendezvous"),
                         timeout_s=30, join_timeout_s=8)
