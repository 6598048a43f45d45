"""Hardware discovery (sys_detect.cpp:20-154 counterpart): the port's copy
of jampack_tpu/runtime/sysinfo.py's host half, and the card's memory from
PyTorch.

The reference caches core count, available memory, and CUDA presence/VRAM
to clamp thread counts and decide GPU offload; the CLI's plan_workers
reads the host half, and HybridEngine gates its BWT device offload on
`fits_on_device` the way the reference gates its CUDA path on the
80%-of-VRAM test (format.hpp:27, bwt.cpp:102-114).  gpu_devices lists
the cards, [] without one; without a card the memory half raises: nothing
here answers "no" and lets a caller run on the host without saying so.
"""

import os


def core_count() -> int:
    """Host cores (sys_detect.cpp:22-55)."""
    return os.cpu_count() or 1


def available_memory() -> int:
    """Host bytes available (sys_detect.cpp:57-84)."""
    try:
        return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError, AttributeError):
        return 1 << 32


def gpu_devices() -> list:
    """The accelerator inventory (the counterpart of the JAX package's
    tpu_devices): torch.device("cuda:i") for every card of this host, []
    without one."""
    import torch

    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def device_memory(device="cuda") -> int:
    """Total bytes of the card `device` (torch.cuda.mem_get_info; "cuda"
    alone is the calling thread's current card); raises RuntimeError when
    this machine has no card."""
    import torch

    from ..device import resolve

    dev = resolve(device)
    if dev.type != "cuda":
        raise ValueError(f"device_memory needs a CUDA device, not {device!r}")
    return int(torch.cuda.mem_get_info(dev)[1])


def fits_on_device(block_size: int, budget: float = 0.8,
                   device="cuda") -> bool:
    """The reference's GPU-offload test: ~6 bytes of working set per input
    byte must fit in `budget` of device memory (format.hpp:27).  Raises
    RuntimeError when this machine has no card."""
    return 6 * block_size <= budget * device_memory(device)
