"""Device-dispatch policy, the kernel library, and the launch counters.

``device_default()`` keeps the JAX package's policy
(``dextractor_tpu/utils/dispatch.py``): the env var ``DXT_DEVICE`` wins
("1" forces the device pipeline, "0" the native host path); otherwise the
device pipeline runs exactly when a CUDA device is present.

``resolve_device(device)`` turns a codec's ``device`` argument into a
``torch.device`` (or None for the native host path).  A CUDA request on a
host without CUDA raises: nothing falls back to the CPU behind the caller.

``kernels()`` builds (at first use) and loads the CUDA library
(ops/_build.py); it raises when the build or the load fails.

``LAUNCHES`` counts the kernel launches per kernel; each wrapper in
ops/emit.py, ops/lut.py, ops/decode_chains.py, ops/expand.py,
ops/pack2bit.py and ops/tag.py adds one where it launches its kernel.  ``TWIN_CALLS``
counts the calls of each kernel's plain PyTorch twin.  ``reset_counts()``
zeroes both.
"""

from __future__ import annotations

import os

import torch

KERNELS = ("encode_plain", "encode_run", "pack_tags", "lut_gather", "pack_words",
           "decode_plain", "decode_run", "expand_runs", "pack2bit", "unpack2bit",
           "tag_route")

LAUNCHES = dict.fromkeys(KERNELS, 0)
TWIN_CALLS = dict.fromkeys(KERNELS, 0)


def reset_counts() -> None:
    for counts in (LAUNCHES, TWIN_CALLS):
        for k in counts:
            counts[k] = 0


def device_default() -> bool:
    v = os.environ.get("DXT_DEVICE")
    if v:
        return v == "1"
    return torch.cuda.is_available()


def resolve_device(device) -> torch.device | None:
    """``device`` of a codec entry point -> torch.device, or None for the
    native host path.  None applies ``device_default()``; True means CUDA;
    a string or torch.device is taken as given ("cpu" runs the device
    pipeline on the plain twins)."""
    if device is None:
        device = device_default()
    if device is False:
        return None
    dev = torch.device("cuda" if device is True else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was requested but "
                           "torch.cuda.is_available() is False")
    return dev


_LIB = None


def kernels():
    """The loaded CUDA kernel library (built on first use)."""
    global _LIB
    if _LIB is None:
        from ..ops._build import load_library

        _LIB = load_library()
    return _LIB
