"""Build, bind and launch the port's CUDA kernels.

``csrc/*.cu`` is compiled at first use with ``nvcc`` into a shared
library with a plain C interface (``-gencode arch=compute_90a,code=sm_90a``),
loaded with ``ctypes``. The library goes into ``libpga_tpu_torch/_build/``
(listed in ``.gitignore``) under a name that carries a hash of the
source, so an edited source is rebuilt. Nothing here runs at import
time: this module imports on machines without ``nvcc`` or a card.

``LAUNCHES`` counts kernel launches by row-map layout; a wrapper adds
one where it launches its kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import torch

from libpga_tpu_torch.ops.select import resolve_selection

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# --fmad=false: no multiply-add contraction, so the kernel's float32
# selection arithmetic rounds exactly as the plain torch version does.
NVCC_FLAGS = ["-std=c++17", "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

LAUNCHES = {"pingpong": 0, "riffle": 0}

SEL_IDS = {"tournament": 0, "truncation": 1, "linear_rank": 2}
MUTATE_IDS = {"point": 0, "gaussian": 1, "swap": 2}

_libs: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(name: str = "deme_breed", verbose: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` into ``_build/lib<name>-<hash>.so``
    unless that file exists. Returns its path; raises on failure."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(ARCH_FLAGS + NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib = BUILD / f"lib{name}-{digest}.so"
    if lib.exists():
        return lib
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", str(tmp), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed building {src.name}:\n{res.stdout}\n{res.stderr}"
        )
    if verbose:
        print(res.stderr.strip())
    os.replace(tmp, lib)
    return lib


def build_all(verbose: bool = False) -> None:
    """Build every kernel source, one nvcc per source, all started
    together."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        for fut in [pool.submit(build, n, verbose) for n in names]:
            fut.result()


def _library(name: str = "deme_breed") -> ctypes.CDLL:
    if name in _libs:
        return _libs[name]
    lib = ctypes.CDLL(str(build(name)))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.deme_breed_launch.argtypes = [
        p, p, p, p, p,          # gin, gout, sout, ranks, mparams
        p, p, p, p, p,          # sel_u, cross, mut_u, gauss, seed
        i, i, i, i, i,          # P, Pp, L, K, G
        i, i, i, i,             # mode, S, D, q
        i, i, f,                # sel kind, tournament size, sel param
        i, i,                   # mutate kind, objective id
        p,                      # stream
    ]
    lib.deme_breed_launch.restype = ctypes.c_int
    lib.deme_breed_error_string.argtypes = [ctypes.c_int]
    lib.deme_breed_error_string.restype = ctypes.c_char_p
    _libs[name] = lib
    return lib


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def deme_breed_cuda(
    genomes: torch.Tensor,
    ranks: torch.Tensor,
    geom,
    parity: int,
    *,
    seed: Optional[torch.Tensor] = None,
    draws=None,
    out: Optional[torch.Tensor] = None,
    tournament_size: int = 2,
    selection: str = "tournament",
    selection_param: Optional[float] = None,
    mutate: str = "point",
    mparams: torch.Tensor,
    obj_id: int = 0,
):
    """Launch ``csrc/deme_breed.cu`` on the current stream: the kernel
    counterpart of ``fused_step.deme_breed_reference`` (same arguments).
    Production mode takes ``seed`` (int64, one element, on the card);
    injected mode takes ``draws``. Raises on bad arguments or a failed
    launch; never runs anything else in the kernel's place."""
    dev = genomes.device
    if dev.type != "cuda":
        raise ValueError("deme_breed_cuda needs CUDA tensors")
    G, K, L, Pp = geom.G, geom.K, geom.L, geom.Pp
    if not 1 <= K <= 1024:
        raise ValueError(f"deme size {K} outside 1..1024")
    if not 1 <= tournament_size <= 16:
        raise ValueError(f"tournament_size {tournament_size} outside 1..16")
    _check(genomes, "genomes", torch.float32, (Pp, L), dev)
    _check(ranks, "ranks", torch.int32, (G, K), dev)
    _check(mparams, "mparams", torch.float32, (2,), dev)
    if mutate not in MUTATE_IDS:
        raise ValueError(f"unknown mutate kind {mutate!r}")
    param = resolve_selection(selection, selection_param)
    if out is None:
        out = torch.empty_like(genomes)
    _check(out, "out", torch.float32, (Pp, L), dev)
    if out.data_ptr() == genomes.data_ptr():
        raise ValueError("out must not alias genomes: blocks read rows other blocks write")
    sel_u = cross = mut_u = gauss = None
    if draws is not None:
        sel_u, cross, mut_u, gauss = draws.sel_u, draws.cross, draws.mut_u, draws.gauss
        _check(sel_u, "sel_u", torch.float32, (G, K, 2), dev)
        _check(cross, "cross", torch.uint8, (G, K, L), dev)
        _check(mut_u, "mut_u", torch.float32, (G, K, 4), dev)
        if mutate == "gaussian":
            _check(gauss, "gauss", torch.float32, (3, G, K, L), dev)
    else:
        _check(seed, "seed", torch.int64, (1,), dev)
    scores = torch.empty(Pp, device=dev) if obj_id else None
    lib = _library()
    rc = lib.deme_breed_launch(
        genomes.data_ptr(), out.data_ptr(), _ptr(scores), ranks.data_ptr(),
        mparams.data_ptr(),
        _ptr(sel_u), _ptr(cross), _ptr(mut_u), _ptr(gauss),
        _ptr(seed if draws is None else None),
        geom.P, Pp, L, K, G,
        geom.mode(parity), geom.S, geom.D, geom.q,
        SEL_IDS[selection], tournament_size,
        0.0 if param is None else float(param),
        MUTATE_IDS[mutate], int(obj_id),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            "deme_breed launch failed: "
            + lib.deme_breed_error_string(rc).decode()
        )
    LAUNCHES[geom.layout] += 1
    return out, scores
