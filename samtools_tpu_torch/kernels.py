"""Loader of the port's hand-written CUDA kernels (csrc/*.cu) and their
launch counts.

The kernels are built by ``samtools_tpu_torch.build`` into one shared
library with a plain C interface and called through ``ctypes``: pointers
come from ``tensor.data_ptr()`` and the stream from
``torch.cuda.current_stream()``.  Each C entry point returns
``cudaGetLastError()``; a non-zero code raises here.  ``launches`` counts
every launch of each kernel in this process (the wrappers add one where
they launch, and nowhere else).  Two rows of the kernel table are
counted by their own wrappers where they run on the card: K8
``baq_apply`` (ops/baq_device.py: a chunk's front ``apply_expand``,
then one K4 and one K5 launch) and K13 ``stable_order``
(ops/pileup.py: ``torch.sort``).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import build

launches = {"segment_contract": 0, "segment_census": 0, "baq_hmm": 0,
            "baq_finalize": 0, "baq_apply": 0, "stable_order": 0,
            "consensus_segsum": 0, "flagstat": 0, "stats_hists": 0,
            "census_narrow": 0, "pileup_scatter": 0, "pileup_tiled": 0,
            "census_checksum": 0, "chunk_expand": 0, "qual_deltas": 0,
            "apply_expand": 0, "depth_scan": 0, "cov_reduce": 0}

_lib = None
_lock = threading.Lock()
_P = ctypes.c_void_p
_INT = ctypes.c_int
_SIGNATURES = {
    "samtpu_segment_contract": [_P, _P, _INT, _INT, _P, _P, _INT, _INT, _INT,
                                _INT, _INT, _P, _P],
    "samtpu_segment_census": [_P, _P, _P, _P, _P, _INT, _INT, _INT, _INT,
                              _INT, _INT, _P, _P, _INT, _INT, _INT, _INT,
                              _INT, _P, _P],
    "samtpu_baq_hmm": [_P, _P, _P, _P, _P, _P, _P, _INT, _INT, _INT, _INT,
                       ctypes.POINTER(ctypes.c_float), _P, _P, _P, _P, _P],
    "samtpu_baq_finalize": [_P, _P, _P, _P, _INT, _INT, _P, _P],
    "samtpu_consensus_segsum": [_P, _P, _P, _P, _P, _P, _INT, _INT, _INT,
                                _INT, _P],
    "samtpu_flagstat": [_P, _P, _P, _P, ctypes.c_int64, _INT, _P, _P, _P],
    "samtpu_stats_hists": [_P, _P, _P, _P, _P, _P, ctypes.c_int64, _INT,
                           _INT, _INT, _INT, _INT, ctypes.c_int64,
                           ctypes.c_int64, _P, _P],
    "samtpu_census_narrow": [_P, ctypes.c_int64, _INT, ctypes.c_int64,
                             _INT, _P, _P, _P, _P],
    "samtpu_pileup_scatter": [_P, _P, _P, _P, ctypes.c_int64, _INT, _INT,
                              _INT, _P, _P],
    "samtpu_pileup_tiled": [_P, _P, _P, _INT, _INT, _INT, _P, _P],
    "samtpu_census_checksum": [_P, ctypes.c_int64, _INT, _P, _P],
    "samtpu_chunk_expand": [_P, _INT, _INT, _P, ctypes.c_int64, _P, _P, _P,
                            _P, _P, _P, _P, _P, _P, _P, _P],
    "samtpu_qual_deltas": [_P, _P, ctypes.c_int64, _INT, _INT, _P, _P, _P,
                           _P, _P],
    "samtpu_apply_expand": [_P, _INT, _INT, _INT, _P, ctypes.c_int64, _P, _P,
                            _P, _P],
    "samtpu_depth_scan": [_P, _P, ctypes.c_int64, ctypes.c_int64, _INT, _P,
                          _P, _P],
    "samtpu_cov_reduce": [_P, ctypes.c_int64, ctypes.c_int64,
                          ctypes.c_int64, _INT, _INT, _P, _P, _P, _P],
    # device queries: int64 values written, CUDA error returned
    "samtpu_census_narrow_limits": [ctypes.POINTER(ctypes.c_int64)],
}
# launch-geometry queries: (int arguments, int64 values written)
_LAYOUTS = {"samtpu_baq_hmm_layout": (3, 4)}


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build.build(("cuda",))["cuda"])
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = args
            for name, (n_in, _) in _LAYOUTS.items():
                fn = getattr(lib, name)
                fn.restype = None
                fn.argtypes = [_INT] * n_in + [
                    ctypes.POINTER(ctypes.c_int64)]
            lib.samtpu_cuda_error_string.restype = ctypes.c_char_p
            lib.samtpu_cuda_error_string.argtypes = [ctypes.c_int]
            _lib = lib
    return _lib


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


_SMS: dict = {}


def sm_count(device: torch.device) -> int:
    """The card's number of SMs (launch plans size their grids by it)."""
    got = _SMS.get(device.index)
    if got is None:
        got = _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return got


_SCRATCH: dict = {}


def scratch(kernel: str, device: torch.device, stream: int,
            words: int) -> torch.Tensor:
    """A kernel's int32 scratch for launches on ``stream`` (a CUDA stream
    handle) of ``device``, zeroed once at its first use and kept: the
    kernels that take one (K11's partials and ticket, K7n's maxima and
    ticket) leave its counters at zero again, and launches on one stream
    run one after another, so every later call on that stream reuses it
    as it is.  Each stream has its own: kernels on two streams may
    overlap."""
    key = (kernel, device.index, stream)
    got = _SCRATCH.get(key)
    if got is None or got.numel() < words:
        got = _SCRATCH[key] = torch.zeros(words, dtype=torch.int32,
                                          device=device)
    return got


def layout(entry: str, *args: int) -> tuple[int, ...]:
    """The values a kernel's launch-geometry query writes for ``args``
    (compile-time constants of its source and the sizes they imply)."""
    out = (ctypes.c_int64 * _LAYOUTS[entry][1])()
    getattr(_load(), entry)(*args, out)
    return tuple(out)


def query(entry: str, n: int, device: torch.device) -> tuple[int, ...]:
    """The ``n`` int64 values a device query writes for ``device``
    (raises on a CUDA error)."""
    lib = _load()
    out = (ctypes.c_int64 * n)()
    with torch.cuda.device(device):
        rc = getattr(lib, entry)(out)
    if rc != 0:
        msg = lib.samtpu_cuda_error_string(rc).decode()
        raise RuntimeError(f"{entry}: CUDA error {rc} ({msg})")
    return tuple(out)


def launch(kernel: str, entry: str, *args, device: torch.device) -> None:
    """Call one C entry point with ``device``, the card of its tensors,
    as the current card, raise on a CUDA error, count the launch.  The
    entries read their limits from the current card (``cudaGetDevice``)
    and launch into a stream of ``device``: a mesh shard on another card
    than the current one needs the guard."""
    lib = _load()
    with torch.cuda.device(device):
        rc = getattr(lib, entry)(*args)
    if rc != 0:
        msg = lib.samtpu_cuda_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA error {rc} ({msg})")
    launches[kernel] += 1


def check(t: torch.Tensor, name: str, dtype: torch.dtype,
          shape: tuple) -> None:
    """Validate a kernel argument: dtype, shape (None = any) and
    contiguity."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if len(t.shape) != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def on_card(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the card; False when all lie on the
    CPU (the plain version runs); anything else raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        if len({t.device for t in tensors}) != 1:
            raise ValueError("kernel arguments lie on different cards")
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"kernel arguments on devices {sorted(kinds)}; "
                     "expected all on one CUDA card or all on the CPU")
