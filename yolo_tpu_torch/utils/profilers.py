"""`autobatch` (counterpart of yolo_tpu/utils/profilers.py::autobatch; the rest of that
module, the per-layer profiler, is not ported)."""

from __future__ import annotations

import torch

from yolo_tpu_torch.utils import LOGGER

PEAK_FRACTION = 0.9  # of the card's memory a probe may peak at: room for the optimizer's state and the allocator's slack


def autobatch(probe, device, start: int = 8, max_batch: int = 512) -> int:
    """The largest power-of-two batch, from `start` doubling up to `max_batch`, at which `probe(b)`
    runs on `device` (the JAX package's search; its probe is an f32 predict, the trainer's is its
    own train step). The first batch that runs out of memory, or whose peak on a card passes
    PEAK_FRACTION of the card's memory, ends the search, and the card's cache is emptied → the
    last good batch, or `start` when none ran."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    total = torch.cuda.get_device_properties(dev).total_memory if cuda else 0
    good, b = 0, start
    while b <= max_batch:
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        try:
            probe(b)
            if cuda:
                torch.cuda.synchronize(dev)
        except (torch.cuda.OutOfMemoryError, MemoryError):
            why = "ran out of memory"
        else:
            peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
            why = f"peaked at {peak / 2**30:.1f} of {total / 2**30:.1f} GiB" if peak > PEAK_FRACTION * total > 0 else None
        if cuda:  # outside the handler, so a failed pass's tensors are released first
            torch.cuda.empty_cache()
        if why:
            LOGGER.info(f"autobatch: batch {b} {why}; using {good}")
            break
        if cuda:
            LOGGER.info(f"autobatch: batch {b} fits, peak {peak / 2**30:.1f} GiB")
        good = b
        b *= 2
    LOGGER.info(f"autobatch: selected batch {good}")
    return good or start
