"""Cells cut to a size the CPU tests can hold: 240x320 pans of 6 frames,
480x640 pairs, pools of 2, every request kept."""
import _paths  # noqa: F401
import time

import torch

from harness import runtime


def tiny_cell(name: str) -> runtime.Cell:
    cell = runtime.load_cell(name)
    cell.traffic.update(pool=2, check_every=1, warmup_requests=1)
    if cell.config["driver"] == "sfm":
        cell.config.update(image_size=[240, 320], focal=130.0)
        cell.traffic.update(frames=6, check_requests=1)
    else:
        cell.config.update(image_size=[480, 640], focal=520.0)
        cell.traffic.update(check_requests=2)
    return cell


def rehearse(name: str, seconds: float = 0.2, seed: int = 2 ** 31 + 7):
    """(result, exit code) of one run of the cut cell on the CPU."""
    torch.set_num_threads(2)
    return runtime.run_cell(tiny_cell(name), seed, seconds, False,
                            torch.device("cpu"), time.perf_counter(),
                            runtime.BENCH_DIR.parent)
