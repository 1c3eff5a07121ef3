"""Device warm-up.

Port of adacom_tpu/utils/warmup.py. The first CUDA work in a process pays
for the context, and the first fused scan for loading (or building) the
kernel library. `warm_in_background(device)` starts that work once per
device on a daemon thread when a database is created, so that no query
pays for it: it creates the context on the device, loads the kernel
library (`build.kernels()`) and uploads and pulls 64 words. On the CPU it
does nothing.

An exception on the thread is kept: `ensure_transfer_warm(device)` waits
for the thread and raises it in the caller."""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

import torch

_lock = threading.Lock()
# device -> its warm-up thread; seconds and exception of each device's run
_threads: Dict[torch.device, threading.Thread] = {}
_seconds: Dict[torch.device, float] = {}
_errors: Dict[torch.device, BaseException] = {}


def _warm(device: torch.device) -> None:
    t0 = time.perf_counter()
    try:
        from adacom_tpu_torch import build

        a = torch.arange(64, dtype=torch.int32, device=device)
        build.kernels()
        a.cpu()  # the first pull waits for the context and the upload
    except Exception as e:  # kept for ensure_transfer_warm
        _errors[device] = e
    finally:
        _seconds[device] = time.perf_counter() - t0


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def warm_in_background(device) -> None:
    """Start the warm-up of `device` on a daemon thread, once per device;
    nothing on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    device = _device(device)
    with _lock:
        if device in _threads:
            return
        t = threading.Thread(target=_warm, args=(device,),
                             name="adacom-warmup", daemon=True)
        _threads[device] = t
        t.start()


def ensure_transfer_warm(device=None) -> Optional[float]:
    """Wait until `device` (default: the current CUDA device) is warm,
    starting its warm-up if none was started, and raise the warm-up's
    exception if it failed. Returns the warm-up's seconds, or
    None on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = "cuda"
    device = torch.device(device)
    if device.type != "cuda":
        return None
    device = _device(device)
    warm_in_background(device)
    _threads[device].join()
    if device in _errors:
        raise _errors[device]
    return _seconds[device]
