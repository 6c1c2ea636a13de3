"""PyTorch/CUDA port of the CamRaDepth framework for NVIDIA Hopper.

The JAX package ``camradepth_tpu`` is the reference; this package imports
nothing from it. Entry points run on the card (``device="cuda"``) unless
the caller asks for the CPU, and raise when CUDA is not available.
Importing the package builds nothing: the CUDA sources under ``csrc/``
are compiled with nvcc at first use (see ``ops/_build.py``), and the
loader's C++ host code under ``csrc/host/`` with g++ (see ``native.py``).
"""

import torch


def resolve_device(device) -> torch.device:
    """The ``torch.device`` an entry point runs on. Never drops to the CPU
    on its own: asking for CUDA without a card raises. A CUDA device
    without an index is pinned to the calling thread's current card: a
    worker thread (the trainer's prefetch) starts on card 0, so a rank of
    a process group that runs on another card would copy its batches
    there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
