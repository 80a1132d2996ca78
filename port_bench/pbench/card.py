"""The card beside the window: its name, power limit, and its SM clock,
power draw and temperature sampled by ``nvidia-smi`` while the loop runs
(a frozen copy of ``chip_smoke.CardSampler``)."""

from __future__ import annotations

import subprocess


class CardSampler:
    """Samples the card's SM clock, power draw and temperature with
    nvidia-smi every 100 ms while a block runs; ``stats`` then holds their
    medians and extremes (empty when nvidia-smi gave nothing)."""

    QUERY = "clocks.sm,power.draw,temperature.gpu"

    def __enter__(self):
        self.stats = {}
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={self.QUERY}",
                 "--format=csv,noheader,nounits", "-lms", "100"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None
        return self

    def __exit__(self, *exc):
        if self.proc is None:
            return False
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        rows = []
        for line in out.splitlines():
            try:
                rows.append([float(v) for v in line.split(",")])
            except ValueError:
                continue
        if rows:
            clock, power, temp = (sorted(c) for c in zip(*rows))
            self.stats = {"samples": len(rows),
                          "sm_mhz_median": clock[len(clock) // 2],
                          "sm_mhz_min": clock[0],
                          "power_w_median": power[len(power) // 2],
                          "power_w_max": power[-1],
                          "temp_c_max": temp[-1]}
        return False


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"
    return out.splitlines()[0] if out else "unavailable"
