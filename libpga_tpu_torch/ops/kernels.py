"""Build, bind and launch the port's CUDA kernels.

``csrc/*.cu`` is compiled at first use with ``nvcc`` into a shared
library with a plain C interface (``-gencode arch=compute_90a,code=sm_90a``),
loaded with ``ctypes``. The library goes into ``libpga_tpu_torch/_build/``
(listed in ``.gitignore``) under a name that carries a hash of the
source and the headers it includes, so an edited source is rebuilt.
``csrc/expr_breed.cu`` is a template: each breed with expression hooks
gets its own unit, the hooks that ``ops/expr_cuda.py`` generates followed
by the template, written to ``_build/expr_breed-<hash>.cu`` and built the
same way (:func:`build_expr`); the unit holds both the one-generation and
the multi-generation kernel of those hooks. Nothing here runs at import time: this
module imports on machines without ``nvcc`` or a card.

``LAUNCHES`` counts kernel launches: the uniform-crossover deme breed
by row-map layout ("pingpong", "riffle"), the order-crossover breed
("order"), the multi-generation breed ("multigen", one per launch
whatever its step count; "multigen_order" with order crossover), the
expression breed ("expr", every row map; "expr_order", its order
kernel) and its multi-generation form ("expr_multigen";
"expr_multigen_order"), the GP evaluator by mode (compacted programs, or
raw genomes with static trips), and an island launch of the deme, order
or multi-generation breed once, whatever its island count ("islands",
"islands_order", "islands_multigen", "islands_multigen_order"), and so
an island launch of the expression kernels ("islands_expr",
"islands_expr_order", "islands_expr_multigen",
"islands_expr_multigen_order"). A launch on bfloat16 genomes counts
under the same name with "_bf16" appended ("pingpong_bf16",
"riffle_bf16", "multigen_bf16", "expr_bf16", "expr_multigen_bf16",
"islands_bf16", "islands_multigen_bf16", "islands_expr_bf16",
"islands_expr_multigen_bf16"). A wrapper adds one where it launches its
kernel and nowhere else.

Genomes (and the children, ``out`` and the multi-generation work
buffers, which take the genomes' dtype) are float32 or bfloat16; every
other tensor a kernel takes is float32 (draws, scores, mparams,
coordinates) or integer. The order-crossover kernels take float32 genomes
only, as JAX declines order crossover at bfloat16.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import torch

from libpga_tpu_torch.objectives.classic import FUSED_NONE, FUSED_TSP, ROWWISE_FUSED
from libpga_tpu_torch.ops import expr_cuda
from libpga_tpu_torch.ops.select import resolve_selection

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# --fmad=false: no multiply-add contraction, so the kernel's float32
# selection arithmetic rounds exactly as the plain torch version does.
NVCC_FLAGS = ["-std=c++17", "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

LAUNCHES = {
    "pingpong": 0, "riffle": 0, "order": 0, "multigen": 0, "multigen_order": 0, "expr": 0,
    "expr_order": 0, "expr_multigen": 0, "expr_multigen_order": 0, "gp_eval_opt": 0,
    "gp_eval_static": 0, "islands": 0, "islands_order": 0, "islands_multigen": 0,
    "islands_multigen_order": 0, "pingpong_bf16": 0, "riffle_bf16": 0, "multigen_bf16": 0,
    "expr_bf16": 0, "expr_multigen_bf16": 0, "islands_bf16": 0, "islands_multigen_bf16": 0,
    "islands_expr": 0, "islands_expr_order": 0, "islands_expr_multigen": 0,
    "islands_expr_multigen_order": 0, "islands_expr_bf16": 0, "islands_expr_multigen_bf16": 0,
}
TEMPLATES = ("expr_breed",)  # sources built only with generated hooks in front

SEL_IDS = {"tournament": 0, "truncation": 1, "linear_rank": 2}
MUTATE_IDS = {"point": 0, "gaussian": 1, "swap": 2}
CROSS_IDS = {"uniform": 0, "order": 1}  # the kernels' runtime crossover kind
GENE_IDS = {torch.float32: 0, torch.bfloat16: 1}  # the launchers' gene_dtype
ORDER_THREADS = 64  # children per block of order_breed_kernel and expr_order_kernel
MULTIGEN_MAX_D = 16  # demes per block of the multi-generation kernels
MULTIGEN_ROW_BYTES = 17  # their shared memory per group row (MG_ROW_BYTES)
EXPR_MAX_WARPS = 8  # warps per block of expr_breed_kernel (THREADS / 32)
EXPR_MULTIGEN_MAX_WARPS = 32  # of expr_multigen_kernel (MG_THREADS / 32)
SMEM_BLOCK_BYTES = 232_448  # shared memory a block may use on Hopper

_libs: dict = {}
_expr_libs: dict = {}  # generated source -> built library path


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _count(name: str, genomes: torch.Tensor) -> None:
    """One launch of ``name`` on ``genomes``' gene dtype."""
    LAUNCHES[name + ("_bf16" if genomes.dtype == torch.bfloat16 else "")] += 1


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest(source: bytes) -> str:
    """Hash of a unit: its text, every header under ``csrc/`` and the
    flags."""
    h = hashlib.sha256(source)
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _compile(src: Path, lib: Path, verbose: bool) -> Path:
    if lib.exists():
        return lib
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(CSRC)]
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


def build(name: str = "deme_breed", verbose: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` into ``_build/lib<name>-<hash>.so``
    unless that file exists. Returns its path; raises on failure."""
    src = CSRC / f"{name}.cu"
    return _compile(src, BUILD / f"lib{name}-{_digest(src.read_bytes())}.so", verbose)


def expr_unit(program) -> str:
    """The text of an expression breed's unit: the generated hooks
    (``program.source``), then the template ``csrc/expr_breed.cu``."""
    return program.source + "\n" + (CSRC / "expr_breed.cu").read_text()


def build_expr(program, verbose: bool = False) -> Path:
    """Compile an expression breed's unit into
    ``_build/libexpr_breed-<hash>.so`` unless that file exists; the unit's
    text is kept beside it as ``expr_breed-<hash>.cu``."""
    text = expr_unit(program)
    digest = _digest(text.encode())
    lib = BUILD / f"libexpr_breed-{digest}.so"
    if lib.exists():
        return lib
    BUILD.mkdir(parents=True, exist_ok=True)
    src = BUILD / f"expr_breed-{digest}.cu"
    tmp = src.with_suffix(f".{os.getpid()}.tmp")
    tmp.write_text(text)
    os.replace(tmp, src)
    return _compile(src, lib, verbose)


def build_all(verbose: bool = False, programs=()) -> dict:
    """Build every kernel source (the templates only through
    ``programs``, expression units from ``ops/expr_cuda.generate``), one
    nvcc per unit, all started together. Returns the seconds each unit's
    build took (0 where its library existed), by source name or
    ``expr_breed[i]`` for ``programs[i]``."""
    names = sorted(p.stem for p in CSRC.glob("*.cu") if p.stem not in TEMPLATES)

    def timed(fn, arg):
        t0 = time.perf_counter()
        fn(arg, verbose)
        return time.perf_counter() - t0

    jobs = [(n, build, n) for n in names]
    jobs += [(f"expr_breed[{i}]", build_expr, p) for i, p in enumerate(programs)]
    with ThreadPoolExecutor(max_workers=max(len(jobs), 1)) as pool:
        futs = {key: pool.submit(timed, fn, arg) for key, fn, arg in jobs}
        return {key: fut.result() for key, fut in futs.items()}


def _bindings() -> dict:
    """ctypes signatures of each source's C entry points: source name ->
    {function: (argtypes, restype)}. Pointers and the stream are
    ``c_void_p`` (a plain int would be cut to 32 bits)."""
    p, i, f, s = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_char_p
    return {
        "deme_breed": {
            "deme_breed_launch": ([
                p, p, p, p, p,          # gin, gout, sout, ranks, mparams
                p, p, p, p, p,          # sel_u, cross, mut_u, gauss, seed
                i, i, i, i, i,          # P, Pp, L, K, G
                i, i, i, i,             # mode, S, D, q
                i, i, f,                # sel kind, tournament size, sel param
                i, i, i, i,             # mutate kind, objective id, islands, gene dtype
                p,                      # stream
            ], i),
            "order_breed_launch": ([
                p, p, p, p, p,          # gin, gout, sout, ranks, mparams
                p, p, p, p, p,          # sel_u, fill, mut_u, gauss, seed
                p, i, f,                # coords, C, penalty
                i, i, i, i, i,          # P, Pp, L, K, G
                i, i, f,                # sel kind, tournament size, sel param
                i, i, i,                # mutate kind, objective id, islands
                p,                      # stream
            ], i),
            "multigen_breed_launch": ([
                p, p, p, p, p, p,       # gin, sin, gout, sout, work0, work1
                i, f, p,                # steps, target, mparams
                p, p, p, p, p, p, p,    # sel_u, cross, fill, mut_u, gauss, tie, seed
                i, i, i, i, i,          # P, Pp, L, K, G
                i, i, i, i,             # mode, S, D, q
                i, i, f,                # sel kind, tournament size, sel param
                i, i, i, i,             # crossover kind, mutate kind, objective id, elitism
                i, i, i,                # draw steps, islands, gene dtype
                p,                      # stream
            ], i),
            "deme_breed_error_string": ([i], s),
        },
        "expr_breed": {
            "expr_breed_launch": ([
                p, p, p, p, p,          # gin, gout, sout, ranks, mparams
                p, p, p, p, p,          # sel_u, cross, fill, mut_u, gauss
                p, p, p, p,             # expression planes, row words, seed, consts
                p, i, f,                # coords, C, penalty
                i, i, i, i, i,          # P, Pp, L, K, G
                i, i, i, i,             # mode, S, D, q
                i, i, f,                # sel kind, tournament size, sel param
                i, i, i, i,             # crossover kind, mutate kind, objective id, warps
                i, i,                   # islands, gene dtype
                p,                      # stream
            ], i),
            "expr_multigen_launch": ([
                p, p, p, p, p, p,       # gin, sin, gout, sout, work0, work1
                i, f, p,                # steps, target, mparams
                p, p, p, p, p, p,       # sel_u, cross, fill, mut_u, gauss, tie
                p, p, p, p,             # expression planes, row words, seed, consts
                i, i, i, i, i,          # P, Pp, L, K, G
                i, i, i, i,             # mode, S, D, q
                i, i, f,                # sel kind, tournament size, sel param
                i, i, i, i, i,          # crossover kind, mutate kind, objective id, elitism,
                                        # warps
                i, i, i,                # draw steps, islands, gene dtype
                p,                      # stream
            ], i),
            "expr_breed_error_string": ([i], s),
        },
        "gp_eval": {
            "gp_eval_launch": ([
                p, p, p, p,             # genomes, ops, args, length
                p, p, p, p, p,          # xt, y, consts, fids, out
                i, i, i, i, i, i, i,    # P, T, B, n_vars, n_consts, n_ops, S
                i, i, i,                # tpp, ppb, shared-memory bytes
                p,                      # stream
            ], i),
            "gp_eval_error_string": ([i], s),
        },
    }


def _library(name: str, path: Optional[Path] = None) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` or, for a template,
    the built unit at ``path``; cached by path."""
    key = name if path is None else str(path)
    if key in _libs:
        return _libs[key]
    lib = ctypes.CDLL(str(path or build(name)))
    for fn, (argtypes, restype) in _bindings()[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    _libs[key] = lib
    return lib


def _raise_on(rc: int, lib, name: str) -> None:
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg}")


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


def _check_genomes(genomes: torch.Tensor, shape, device, order: bool = False) -> int:
    """``genomes`` checked as :func:`_check` does, float32 or bfloat16
    (float32 only for ``order`` crossover); returns the launchers'
    gene dtype id."""
    allowed = (torch.float32,) if order else tuple(GENE_IDS)
    if genomes.dtype not in allowed:
        kinds = " or ".join(str(d) for d in allowed)
        raise ValueError(f"genomes has dtype {genomes.dtype}, expected {kinds}"
                         + (" (order crossover breeds float32 genes, as in JAX)" if order else ""))
    _check(genomes, "genomes", genomes.dtype, shape, device)
    return GENE_IDS[genomes.dtype]


def _island_lead(islands: Optional[int]) -> tuple:
    """``(leading shape, island count)`` of a launch: ``((), 1)`` for a
    single population, ``((I,), I)`` for an island launch of I >= 1."""
    if islands is None:
        return (), 1
    if not 1 <= islands <= 65_535:
        raise ValueError(f"islands {islands} outside 1..65535 (the grid's second axis)")
    return (int(islands),), int(islands)


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
    crossover: str = "uniform",
    islands: Optional[int] = None,
):
    """Launch ``deme_breed_kernel`` of ``csrc/deme_breed.cu`` on the
    current stream: the kernel counterpart of
    ``fused_step.deme_breed_reference`` (same arguments, uniform
    crossover; float32 or bfloat16 genomes, its float or bf16 case, the
    children in the genomes' dtype).
    Production mode takes ``seed`` (int64, one element, on the card);
    injected mode takes ``draws``. ``islands`` = I breeds I populations
    in one launch: genomes and ``out`` (I, Pp, L), ranks (I*G, K), one
    seed per island (I,), draws with a leading island axis; scores come
    back (I, Pp). Raises on bad arguments or a failed launch; never runs
    anything else in the kernel's place."""
    dev = genomes.device
    if dev.type != "cuda":
        raise ValueError("deme_breed_cuda needs CUDA tensors")
    if crossover != "uniform":
        raise ValueError(f"deme_breed_cuda breeds uniform crossover, not {crossover!r}")
    if obj_id != FUSED_NONE and obj_id not in ROWWISE_FUSED:
        raise ValueError(f"objective id {obj_id} is not fused with uniform crossover")
    G, K, L, Pp = geom.G, geom.K, geom.L, geom.Pp
    if not 1 <= K <= 1024:
        raise ValueError(f"deme size {K} outside 1..1024")
    if not 1 <= tournament_size <= 16:
        raise ValueError(f"tournament_size {tournament_size} outside 1..16")
    lead, n = _island_lead(islands)
    gene_id = _check_genomes(genomes, lead + (Pp, L), dev)
    _check(ranks, "ranks", torch.int32, (n * G, K), dev)
    _check(mparams, "mparams", torch.float32, (2,), dev)
    if mutate not in MUTATE_IDS:
        raise ValueError(f"unknown mutate kind {mutate!r}")
    param = resolve_selection(selection, selection_param)
    if out is None:
        out = torch.empty_like(genomes)
    _check(out, "out", genomes.dtype, lead + (Pp, L), dev)
    if out.data_ptr() == genomes.data_ptr():
        raise ValueError("out must not alias genomes: blocks read rows other blocks write")
    sel_u = cross = mut_u = gauss = None
    if draws is not None:
        sel_u, cross, mut_u, gauss = draws.sel_u, draws.cross, draws.mut_u, draws.gauss
        _check(sel_u, "sel_u", torch.float32, lead + (G, K, 2), dev)
        _check(cross, "cross", torch.uint8, lead + (G, K, L), dev)
        _check(mut_u, "mut_u", torch.float32, lead + (G, K, 4), dev)
        if mutate == "gaussian":
            _check(gauss, "gauss", torch.float32, lead + (3, G, K, L), dev)
    else:
        _check(seed, "seed", torch.int64, (n,), dev)
    scores = torch.empty(lead + (Pp,), device=dev) if obj_id else None
    lib = _library("deme_breed")
    rc = lib.deme_breed_launch(
        genomes.data_ptr(), out.data_ptr(), _ptr(scores), ranks.data_ptr(),
        mparams.data_ptr(),
        _ptr(sel_u), _ptr(cross), _ptr(mut_u), _ptr(gauss),
        _ptr(seed if draws is None else None),
        geom.P, Pp, L, K, G,
        geom.mode(parity), geom.S, geom.D, geom.q,
        SEL_IDS[selection], tournament_size,
        0.0 if param is None else float(param),
        MUTATE_IDS[mutate], int(obj_id), n, gene_id,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, lib, "deme_breed")
    _count(geom.layout if islands is None else "islands", genomes)
    return out, scores


def order_breed_cuda(
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
    mutate: str = "swap",
    mparams: torch.Tensor,
    obj_id: int = 0,
    crossover: str = "order",
    coords: Optional[torch.Tensor] = None,
    penalty: float = 0.0,
    islands: Optional[int] = None,
):
    """Launch ``order_breed_kernel`` of ``csrc/deme_breed.cu`` on the
    current stream: the kernel counterpart of
    ``fused_step.deme_breed_reference(..., crossover="order")`` (same
    arguments; riffle geometry only). Production mode takes ``seed``
    (int64, one element, on the card); injected mode takes ``draws``
    with the ``fill`` plane. ``obj_id`` 3 (fused TSP) takes ``coords``
    (C, 2) float32 on the card and ``penalty``. ``islands`` = I breeds
    I populations in one launch, shaped as :func:`deme_breed_cuda`'s.
    Raises on bad arguments or a failed launch; never runs anything else
    in the kernel's place."""
    dev = genomes.device
    if dev.type != "cuda":
        raise ValueError("order_breed_cuda needs CUDA tensors")
    if crossover != "order":
        raise ValueError(f"order_breed_cuda breeds order crossover, not {crossover!r}")
    if geom.layout != "riffle":
        raise ValueError("order crossover runs on the riffle layout only")
    G, K, L, Pp = geom.G, geom.K, geom.L, geom.Pp
    if K % ORDER_THREADS or not 1 <= K <= 1024:
        raise ValueError(f"deme size {K} is not a multiple of {ORDER_THREADS} in 1..1024")
    if not 1 <= tournament_size <= 16:
        raise ValueError(f"tournament_size {tournament_size} outside 1..16")
    lead, n = _island_lead(islands)
    _check_genomes(genomes, lead + (Pp, L), dev, order=True)
    _check(ranks, "ranks", torch.int32, (n * G, K), dev)
    _check(mparams, "mparams", torch.float32, (2,), dev)
    if mutate not in MUTATE_IDS:
        raise ValueError(f"unknown mutate kind {mutate!r}")
    if obj_id not in (FUSED_NONE, FUSED_TSP) and obj_id not in ROWWISE_FUSED:
        raise ValueError(f"objective id {obj_id} is not fused with order crossover")
    C = 0
    if obj_id == FUSED_TSP:
        if coords is None or coords.ndim != 2:
            raise ValueError("the fused TSP score needs coords of shape (C, 2)")
        C = coords.shape[0]
        _check(coords, "coords", torch.float32, (C, 2), dev)
        if C < 1:
            raise ValueError("coords holds no city")
    param = resolve_selection(selection, selection_param)
    if out is None:
        out = torch.empty_like(genomes)
    _check(out, "out", torch.float32, lead + (Pp, L), dev)
    if out.data_ptr() == genomes.data_ptr():
        raise ValueError("out must not alias genomes: blocks read rows other blocks write")
    sel_u = fill = mut_u = gauss = None
    if draws is not None:
        sel_u, fill, mut_u, gauss = draws.sel_u, draws.fill, draws.mut_u, draws.gauss
        _check(sel_u, "sel_u", torch.float32, lead + (G, K, 2), dev)
        if fill is None:
            raise ValueError("injected order draws need the fill plane")
        _check(fill, "fill", torch.float32, lead + (G, K, L), dev)
        _check(mut_u, "mut_u", torch.float32, lead + (G, K, 4), dev)
        if mutate == "gaussian":
            _check(gauss, "gauss", torch.float32, lead + (3, G, K, L), dev)
    else:
        _check(seed, "seed", torch.int64, (n,), dev)
    scores = torch.empty(lead + (Pp,), device=dev) if obj_id else None
    lib = _library("deme_breed")
    rc = lib.order_breed_launch(
        genomes.data_ptr(), out.data_ptr(), _ptr(scores), ranks.data_ptr(),
        mparams.data_ptr(),
        _ptr(sel_u), _ptr(fill), _ptr(mut_u), _ptr(gauss),
        _ptr(seed if draws is None else None),
        _ptr(coords if obj_id == FUSED_TSP else None), C, float(penalty),
        geom.P, Pp, L, K, G,
        SEL_IDS[selection], tournament_size,
        0.0 if param is None else float(param),
        MUTATE_IDS[mutate], int(obj_id), n,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, lib, "deme_breed")
    LAUNCHES["order" if islands is None else "islands_order"] += 1
    return out, scores


def _multigen_checks(genomes, scores, geom, steps, tournament_size, elitism, mparams,
                     order: bool, lead: tuple = ()) -> tuple:
    """The checks both multi-generation wrappers make (``order``: order
    crossover, which takes one riffle deme per group; ``lead``: the
    island axis of an island launch); returns ``steps`` as an int and the
    launchers' gene dtype id."""
    dev = genomes.device
    G, K, L, Pp, D = geom.G, geom.K, geom.L, geom.Pp, geom.D
    if not 1 <= K <= 1024:
        raise ValueError(f"deme size {K} outside 1..1024")
    if not 1 <= D <= MULTIGEN_MAX_D or G % D:
        raise ValueError(f"{D} demes per group outside 1..{MULTIGEN_MAX_D} or not dividing {G}")
    if order and (D != 1 or geom.layout != "riffle"):
        raise ValueError("order crossover runs one riffle deme per group (D = 1)")
    if not 1 <= tournament_size <= 16:
        raise ValueError(f"tournament_size {tournament_size} outside 1..16")
    if not 0 <= elitism < K:
        raise ValueError(f"elitism {elitism} outside 0..{K - 1}")
    steps = int(steps)
    if steps < 0:
        raise ValueError(f"steps {steps} is negative")
    gene_id = _check_genomes(genomes, lead + (Pp, L), dev, order=order)
    _check(scores, "scores", torch.float32, lead + (Pp,), dev)
    _check(mparams, "mparams", torch.float32, (2,), dev)
    return steps, gene_id


def _multigen_buffers(genomes, out, work, steps: int):
    """``(out, [work0, work1])``: the children's buffer and the kernel's
    two scratch buffers (made where None and ``steps`` needs them: one
    from 2 steps, two from 3; None where unused), of the genomes' dtype,
    none aliasing ``genomes`` or each other."""
    dev, shape = genomes.device, tuple(genomes.shape)
    if out is None:
        out = torch.empty_like(genomes)
    _check(out, "out", genomes.dtype, shape, dev)
    if out.data_ptr() == genomes.data_ptr():
        raise ValueError("out must not alias genomes: blocks read rows other blocks write")
    work = list(work or ())
    while len(work) < min(max(steps - 1, 0), 2):
        work.append(torch.empty_like(genomes))
    for n, w in enumerate(work):
        _check(w, f"work[{n}]", genomes.dtype, shape, dev)
        if w.data_ptr() in (genomes.data_ptr(), out.data_ptr()):
            raise ValueError("a work buffer must not alias genomes or out")
    return out, work + [None, None]


def _multigen_draws(draws, seed, geom, steps: int, crossover, mutate, dev, lead: tuple = ()):
    """``(T, (sel_u, cross, fill, mut_u, gauss, tie))`` of an injected
    multigen launch, each tensor with a leading axis of T >= ``steps``
    sub-generations after the island axis ``lead`` (``cross`` for
    uniform crossover, ``fill`` for order crossover, none of them for a
    crossover hook (``crossover`` None); ``gauss`` for gaussian
    mutation; else None), or ``(0, all None)`` in production mode
    (``seed`` checked: one per island)."""
    G, K, L = geom.G, geom.K, geom.L
    if draws is None:
        _check(seed, "seed", torch.int64, (lead[0] if lead else 1,), dev)
        return 0, (None, None, None, None, None, None)
    T = draws.sel_u.shape[len(lead)]
    if T < steps:
        raise ValueError(f"injected draws hold {T} sub-generations, steps is {steps}")
    lead = lead + (T,)
    _check(draws.sel_u, "sel_u", torch.float32, lead + (G, K, 2), dev)
    _check(draws.mut_u, "mut_u", torch.float32, lead + (G, K, 4), dev)
    if draws.tie is None:
        raise ValueError("injected multigen draws need the tie words")
    _check(draws.tie, "tie", torch.int64, lead + (G, K), dev)
    cross = fill = gauss = None
    if crossover == "uniform":
        cross = draws.cross
        _check(cross, "cross", torch.uint8, lead + (G, K, L), dev)
    elif crossover == "order":
        fill = draws.fill
        if fill is None:
            raise ValueError("injected order draws need the fill plane")
        _check(fill, "fill", torch.float32, lead + (G, K, L), dev)
    if mutate == "gaussian":
        gauss = draws.gauss
        _check(gauss, "gauss", torch.float32, lead + (3, G, K, L), dev)
    return T, (draws.sel_u, cross, fill, draws.mut_u, gauss, draws.tie)


def multigen_breed_cuda(
    genomes: torch.Tensor,
    scores: torch.Tensor,
    geom,
    parity: int,
    steps: int,
    target: float,
    *,
    seed: Optional[torch.Tensor] = None,
    draws=None,
    out: Optional[torch.Tensor] = None,
    work=None,
    tournament_size: int = 2,
    selection: str = "tournament",
    selection_param: Optional[float] = None,
    mutate: str = "point",
    mparams: torch.Tensor,
    obj_id: int,
    elitism: int = 0,
    crossover: str = "uniform",
    islands: Optional[int] = None,
):
    """Launch ``multigen_breed_kernel`` of ``csrc/deme_breed.cu`` on the
    current stream: the kernel counterpart of
    ``fused_step.multigen_breed_reference`` (same arguments; uniform or
    order crossover, the latter one riffle deme per group and float32
    genomes only; uniform crossover on float32 or bfloat16 genomes). ``steps``
    generations (0 = the row permutation only) of every group of
    ``geom`` in one launch, a group freezing once its best reaches
    ``target``. Production mode takes ``seed`` (int64, one element, on
    the card); injected mode takes ``draws`` whose tensors carry a
    leading axis of at least ``steps`` sub-generations and the ``tie``
    words (order crossover: the ``fill`` plane). ``work`` is a pair of
    (Pp, L) scratch tensors (made here when None and ``steps`` needs
    them: one from 2 steps, two from 3). Returns ``(genomes (Pp, L),
    scores (Pp,))`` in physical row order. ``islands`` = I breeds I
    populations in one launch: genomes, scores, ``out`` and ``work``
    with a leading island axis (I, Pp, L) / (I, Pp), one seed per island
    (I,), injected draws (I, T, ...). Raises on bad arguments or a
    failed launch; never runs anything else in the kernel's place."""
    dev = genomes.device
    if dev.type != "cuda":
        raise ValueError("multigen_breed_cuda needs CUDA tensors")
    if crossover not in CROSS_IDS:
        raise ValueError(f"multigen_breed_cuda breeds uniform or order crossover, not {crossover!r}")
    if obj_id not in ROWWISE_FUSED:
        raise ValueError(f"objective id {obj_id} has no rowwise fused form: multigen needs one")
    if mutate not in MUTATE_IDS:
        raise ValueError(f"unknown mutate kind {mutate!r}")
    G, K, L, Pp, D = geom.G, geom.K, geom.L, geom.Pp, geom.D
    order = crossover == "order"
    lead, n = _island_lead(islands)
    steps, gene_id = _multigen_checks(genomes, scores, geom, steps, tournament_size, elitism,
                                      mparams, order, lead)
    param = resolve_selection(selection, selection_param)
    out, work = _multigen_buffers(genomes, out, work, steps)
    draw_steps, (sel_u, cross, fill, mut_u, gauss, tie) = _multigen_draws(
        draws, seed, geom, steps, crossover, mutate, dev, lead)
    s_out = torch.empty(lead + (Pp,), device=dev)
    lib = _library("deme_breed")
    rc = lib.multigen_breed_launch(
        genomes.data_ptr(), scores.data_ptr(), out.data_ptr(), s_out.data_ptr(),
        _ptr(work[0]), _ptr(work[1]),
        steps, float(target), mparams.data_ptr(),
        _ptr(sel_u), _ptr(cross), _ptr(fill), _ptr(mut_u), _ptr(gauss), _ptr(tie),
        _ptr(seed if draws is None else None),
        geom.P, Pp, L, K, G,
        geom.mode(parity), geom.S, D, geom.q,
        SEL_IDS[selection], tournament_size,
        0.0 if param is None else float(param),
        CROSS_IDS[crossover], MUTATE_IDS[mutate], int(obj_id), int(elitism),
        draw_steps, n, gene_id,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, lib, "deme_breed")
    key = "multigen_order" if order else "multigen"
    _count(key if islands is None else "islands_" + key, genomes)
    return out, s_out


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def expr_warps(K: int, L: int, obj_rows: int, D: Optional[int] = None, order: bool = False,
               cities: int = 0) -> int:
    """Warps per block of ``expr_breed_kernel`` (``D`` None: up to 8,
    beside ``row_of_rank``), of ``expr_order_kernel`` (``D`` None and
    ``order``: always ``ORDER_THREADS / 32``, beside ``row_of_rank``,
    the walkers' visited bitmasks of ceil(L/32) words each and
    min(``cities``, L) staged TSP coordinates) or of
    ``expr_multigen_kernel`` (a group of ``D`` demes: up to 32, beside
    the group's 17 bytes per row and, with ``order``, ceil(L/32) words
    of bitmask for each child walking at once, min(D*K, threads)): fewer
    where each warp's child row and ``obj_rows`` objective rows of L
    floats do not fit in a block's shared memory (1 KB kept for the
    kernel's static arrays). Raises where not even one warp fits."""
    per_warp = (1 + obj_rows) * L * 4
    words = -(-L // 32)
    limit = SMEM_BLOCK_BYTES - 1024
    if D is None and order:
        most = ORDER_THREADS // 32
        fixed = (K + words * ORDER_THREADS) * 4 + min(cities, L) * 8
        warps = most if fixed + most * per_warp <= limit else 0
    elif D is None:
        fixed = 4 * K
        warps = min(EXPR_MAX_WARPS, (limit - fixed) // per_warp)
    else:
        W = D * K
        rows = _round16(W * MULTIGEN_ROW_BYTES)
        warps = EXPR_MULTIGEN_MAX_WARPS
        while warps:
            walk = _round16(words * min(W, 32 * warps) * 4) if order else 0
            fixed = rows + walk
            if fixed + warps * per_warp <= limit:
                break
            warps -= 1
    if warps < 1:
        raise ValueError(
            f"genome length {L} with {obj_rows} objective rows needs {per_warp} bytes of"
            f" shared memory per warp: more than a block holds beside {fixed} bytes of"
            " rank and walk state"
        )
    return warps


def _expr_hooks(crossover, mutate, objective, obj_id: int, L: int, who: str, multigen=False):
    """``(crossover op or None, mutate op or None, obj_id)`` of a breed
    with expression hooks, checked: a builtin crossover is uniform or
    order, a builtin mutation point / gaussian / swap, a builtin
    objective rowwise-fused (or, one generation per launch, none, or the
    coordinate TSP with order crossover); at least one hook is an
    expression; none is pinned to another genome length. An expression
    ``objective`` sets ``obj_id`` to none."""
    cross_op = crossover if callable(crossover) else None
    mut_op = mutate if callable(mutate) else None
    if cross_op is None and crossover not in CROSS_IDS:
        raise ValueError(f"{who} breeds uniform, order or expression crossover, not {crossover!r}")
    if mut_op is None and mutate not in MUTATE_IDS:
        raise ValueError(f"unknown mutate kind {mutate!r}")
    tsp_ok = not multigen and crossover == "order"
    if objective is not None:
        obj_id = FUSED_NONE
    elif multigen and obj_id not in ROWWISE_FUSED:
        raise ValueError(f"objective id {obj_id} has no rowwise fused form: multigen needs one")
    elif obj_id not in (FUSED_NONE, *ROWWISE_FUSED) and not (tsp_ok and obj_id == FUSED_TSP):
        raise ValueError(f"objective id {obj_id} is not fused with the expression breed")
    if cross_op is None and mut_op is None and objective is None:
        builtin = "multigen_breed_cuda" if multigen else "deme_breed_cuda"
        raise ValueError(f"no expression hook: the builtin breed is {builtin}")
    for op in (cross_op, mut_op, objective):
        pin = getattr(op, "pinned_genome_len", None)
        if pin and pin != L:
            raise ValueError(f"expression {op.expression!r} is pinned to genome length {pin}, not {L}")
    return cross_op, mut_op, obj_id


def _expr_draws(draws, program, lead: tuple, geom, dev):
    """``(expr_gene, expr_row)`` of injected draws, checked where the
    hooks read them (else None): planes ``lead + (4, G, K, L)``, words
    ``lead + (G, K, 4)``; ``lead`` is the island axis and, at several
    generations per launch, the sub-generation axis after it."""
    G, K, L = geom.G, geom.K, geom.L
    xgene = xrow = None
    if program.gene_planes:
        xgene = draws.expr_gene
        if xgene is None:
            raise ValueError("injected draws need the expression planes expr_gene")
        _check(xgene, "expr_gene", torch.float32, lead + (4, G, K, L), dev)
    if program.row_words:
        xrow = draws.expr_row
        if xrow is None:
            raise ValueError("injected draws need the expression words expr_row")
        _check(xrow, "expr_row", torch.float32, lead + (G, K, 4), dev)
    return xgene, xrow


def _expr_library(program) -> ctypes.CDLL:
    """The loaded unit of ``program``'s hooks, built at first use."""
    if program.source not in _expr_libs:
        _expr_libs[program.source] = build_expr(program)
    return _library("expr_breed", _expr_libs[program.source])


def expr_breed_cuda(
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
    mutate="point",
    mparams: torch.Tensor,
    obj_id: int = 0,
    crossover="uniform",
    objective=None,
    coords: Optional[torch.Tensor] = None,
    penalty: float = 0.0,
    islands: Optional[int] = None,
):
    """Launch ``expr_breed_kernel`` or, for order crossover,
    ``expr_order_kernel``, of the template ``csrc/expr_breed.cu`` with
    the hooks generated for this breed (``expr_cuda.program_for``; built
    at first use, :func:`build_expr`), on the current stream: the kernel
    counterpart of ``fused_step.deme_breed_reference`` with an
    expression crossover or mutation (an operator of
    ``ops/breed_expr.py``) or objective (``objective``, a
    ``from_expression`` objective; else ``obj_id`` names a builtin
    rowwise-fused one or, with order crossover, the coordinate TSP,
    which takes ``coords`` (C, 2) float32 on the card and ``penalty``).
    Uniform or order crossover and point / gaussian / swap mutation stay
    builtin where no expression replaces them; every row map (order
    crossover: the riffle and float32 genomes; otherwise float32 or
    bfloat16 genomes, the children in their dtype). Production mode takes ``seed``; injected
    mode takes ``draws`` with the expression planes ``expr_gene`` (4, G,
    K, L) and words ``expr_row`` (G, K, 4) where the hooks read them
    (order crossover: the ``fill`` plane). ``islands`` = I breeds I
    populations in one launch, shaped as :func:`deme_breed_cuda`'s
    (genomes and ``out`` (I, Pp, L), ranks (I*G, K), one seed per island
    (I,), every injected tensor with a leading island axis, scores (I,
    Pp)); the constant tables and ``coords`` are shared. Raises on bad
    arguments or a failed build or launch; never runs anything else in
    the kernel's place."""
    dev = genomes.device
    if dev.type != "cuda":
        raise ValueError("expr_breed_cuda needs CUDA tensors")
    G, K, L, Pp = geom.G, geom.K, geom.L, geom.Pp
    cross_op, mut_op, obj_id = _expr_hooks(crossover, mutate, objective, obj_id, L, "expr_breed_cuda")
    order = crossover == "order"
    if not 1 <= K <= 1024:
        raise ValueError(f"deme size {K} outside 1..1024")
    if order and (geom.layout != "riffle" or K % ORDER_THREADS):
        raise ValueError(f"order crossover needs the riffle and a deme size that is a multiple"
                         f" of {ORDER_THREADS}, not {geom.layout} K={K}")
    if not 1 <= tournament_size <= 16:
        raise ValueError(f"tournament_size {tournament_size} outside 1..16")
    lead, n = _island_lead(islands)
    gene_id = _check_genomes(genomes, lead + (Pp, L), dev, order=order)
    _check(ranks, "ranks", torch.int32, (n * G, K), dev)
    _check(mparams, "mparams", torch.float32, (2,), dev)
    C = 0
    if obj_id == FUSED_TSP:
        if coords is None or coords.ndim != 2 or coords.shape[0] < 1:
            raise ValueError("the fused TSP score needs coords of shape (C, 2), C >= 1")
        C = coords.shape[0]
        _check(coords, "coords", torch.float32, (C, 2), dev)
    param = resolve_selection(selection, selection_param)
    program = expr_cuda.program_for(cross_op, mut_op, objective)
    warps = expr_warps(K, L, program.obj_rows, order=order, cities=C)
    if out is None:
        out = torch.empty_like(genomes)
    _check(out, "out", genomes.dtype, lead + (Pp, L), dev)
    if out.data_ptr() == genomes.data_ptr():
        raise ValueError("out must not alias genomes: blocks read rows other blocks write")
    sel_u = cross = fill = mut_u = gauss = xgene = xrow = None
    if draws is not None:
        sel_u, mut_u = draws.sel_u, draws.mut_u
        _check(sel_u, "sel_u", torch.float32, lead + (G, K, 2), dev)
        _check(mut_u, "mut_u", torch.float32, lead + (G, K, 4), dev)
        if order:
            fill = draws.fill
            if fill is None:
                raise ValueError("injected order draws need the fill plane")
            _check(fill, "fill", torch.float32, lead + (G, K, L), dev)
        elif cross_op is None:
            cross = draws.cross
            _check(cross, "cross", torch.uint8, lead + (G, K, L), dev)
        if mutate == "gaussian":
            gauss = draws.gauss
            _check(gauss, "gauss", torch.float32, lead + (3, G, K, L), dev)
        xgene, xrow = _expr_draws(draws, program, lead, geom, dev)
    else:
        _check(seed, "seed", torch.int64, (n,), dev)
    scores = (torch.empty(lead + (Pp,), device=dev) if (objective is not None or obj_id)
              else None)
    lib = _expr_library(program)
    rc = lib.expr_breed_launch(
        genomes.data_ptr(), out.data_ptr(), _ptr(scores), ranks.data_ptr(),
        mparams.data_ptr(),
        _ptr(sel_u), _ptr(cross), _ptr(fill), _ptr(mut_u), _ptr(gauss), _ptr(xgene), _ptr(xrow),
        _ptr(seed if draws is None else None), program.consts_on(dev).data_ptr(),
        _ptr(coords if C else None), C, float(penalty),
        geom.P, Pp, L, K, G,
        geom.mode(parity), geom.S, geom.D, geom.q,
        SEL_IDS[selection], tournament_size,
        0.0 if param is None else float(param),
        CROSS_IDS["order" if order else "uniform"], MUTATE_IDS.get(mutate, 0) if mut_op is None else 0,
        int(obj_id), warps, n, gene_id,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, lib, "expr_breed")
    key = "expr_order" if order else "expr"
    _count(key if islands is None else "islands_" + key, genomes)
    return out, scores


def expr_multigen_cuda(
    genomes: torch.Tensor,
    scores: torch.Tensor,
    geom,
    parity: int,
    steps: int,
    target: float,
    *,
    seed: Optional[torch.Tensor] = None,
    draws=None,
    out: Optional[torch.Tensor] = None,
    work=None,
    tournament_size: int = 2,
    selection: str = "tournament",
    selection_param: Optional[float] = None,
    mutate="point",
    mparams: torch.Tensor,
    obj_id: int = 0,
    elitism: int = 0,
    crossover="uniform",
    objective=None,
    islands: Optional[int] = None,
):
    """Launch ``expr_multigen_kernel``, the multi-generation entry of
    the expression breed's unit (the same build as :func:`expr_breed_cuda`
    for these hooks), on the current stream: the kernel counterpart of
    ``fused_step.multigen_breed_reference`` with an expression crossover,
    mutation or ``objective`` (same arguments as
    :func:`multigen_breed_cuda`, plus ``objective``; uniform, order or
    expression crossover; bfloat16 genomes as there). Injected ``draws`` carry a leading axis of at
    least ``steps`` sub-generations, the tie words (order crossover: the
    ``fill`` plane) and, where the hooks read them, ``expr_gene`` (T, 4,
    G, K, L) and ``expr_row`` (T, G, K, 4). Returns ``(genomes (Pp, L),
    scores (Pp,))`` in physical row order. ``islands`` = I breeds I
    populations in one launch, shaped as :func:`multigen_breed_cuda`'s
    (injected draws (I, T, ...), the expression planes and words
    included). Raises on bad arguments or a failed build or launch; never
    runs anything else in the kernel's place."""
    dev = genomes.device
    if dev.type != "cuda":
        raise ValueError("expr_multigen_cuda needs CUDA tensors")
    G, K, L, Pp, D = geom.G, geom.K, geom.L, geom.Pp, geom.D
    cross_op, mut_op, obj_id = _expr_hooks(crossover, mutate, objective, obj_id, L,
                                           "expr_multigen_cuda", multigen=True)
    order = crossover == "order"
    lead, n = _island_lead(islands)
    steps, gene_id = _multigen_checks(genomes, scores, geom, steps, tournament_size, elitism,
                                      mparams, order, lead)
    param = resolve_selection(selection, selection_param)
    program = expr_cuda.program_for(cross_op, mut_op, objective)
    warps = expr_warps(K, L, program.obj_rows, D=D, order=order)
    out, work = _multigen_buffers(genomes, out, work, steps)
    draw_steps, (sel_u, cross, fill, mut_u, gauss, tie) = _multigen_draws(
        draws, seed, geom, steps, None if cross_op is not None else crossover, mutate, dev, lead)
    xgene = xrow = None
    if draws is not None:
        xgene, xrow = _expr_draws(draws, program, lead + (draw_steps,), geom, dev)
    s_out = torch.empty(lead + (Pp,), device=dev)
    lib = _expr_library(program)
    rc = lib.expr_multigen_launch(
        genomes.data_ptr(), scores.data_ptr(), out.data_ptr(), s_out.data_ptr(),
        _ptr(work[0]), _ptr(work[1]),
        steps, float(target), mparams.data_ptr(),
        _ptr(sel_u), _ptr(cross), _ptr(fill), _ptr(mut_u), _ptr(gauss), _ptr(tie),
        _ptr(xgene), _ptr(xrow), _ptr(seed if draws is None else None),
        program.consts_on(dev).data_ptr(),
        geom.P, Pp, L, K, G,
        geom.mode(parity), geom.S, D, geom.q,
        SEL_IDS[selection], tournament_size,
        0.0 if param is None else float(param),
        CROSS_IDS["order" if order else "uniform"], MUTATE_IDS.get(mutate, 0) if mut_op is None else 0,
        int(obj_id), int(elitism), warps, draw_steps, n, gene_id,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, lib, "expr_breed")
    key = "expr_multigen_order" if order else "expr_multigen"
    _count(key if islands is None else "islands_" + key, genomes)
    return out, s_out


def gp_eval_cuda(
    *,
    xt: torch.Tensor,
    y: torch.Tensor,
    consts: torch.Tensor,
    fids: torch.Tensor,
    plan: dict,
    genomes: Optional[torch.Tensor] = None,
    prog=None,
    max_nodes: int,
    n_ops: int,
) -> torch.Tensor:
    """Launch ``csrc/gp_eval.cu`` on the current stream: the kernel
    counterpart of ``ops/gp_eval.py``'s plain scorers. Exactly one of
    ``genomes`` (P, 2T) float32 (static trips, ``LAUNCHES["gp_eval_static"]``)
    or ``prog`` (an ``EvalProgram``, ``LAUNCHES["gp_eval_opt"]``) is
    given. ``plan`` is a ``gp_eval_plan`` dict for this P and B. Returns
    (P,) float32 scores. Raises on bad arguments or a failed launch;
    never runs anything else in the kernel's place."""
    if (genomes is None) == (prog is None):
        raise ValueError("pass exactly one of genomes= or prog=")
    first = genomes if genomes is not None else prog.ops
    dev = first.device
    if dev.type != "cuda":
        raise ValueError("gp_eval_cuda needs CUDA tensors")
    T = max_nodes
    n_vars, B = xt.shape
    n_consts = consts.shape[0]
    _check(xt, "xt", torch.float32, (n_vars, B), dev)
    _check(y, "y", torch.float32, (B,), dev)
    _check(consts, "consts", torch.float32, (n_consts,), dev)
    _check(fids, "fids", torch.int32, (n_ops + 1,), dev)
    if genomes is not None:
        P = genomes.shape[0]
        _check(genomes, "genomes", torch.float32, (P, 2 * T), dev)
        ops = args = length = None
        mode = "gp_eval_static"
    else:
        P = prog.ops.shape[0]
        ops, args, length = prog.ops, prog.args, prog.length
        _check(ops, "ops", torch.int32, (P, T), dev)
        _check(args, "args", torch.float32, (P, T), dev)
        _check(length, "length", torch.int32, (P,), dev)
        mode = "gp_eval_opt"
    if plan["samples"] != B or plan["pop"] != P or plan["max_nodes"] != T:
        raise ValueError(f"plan is for {plan['pop']}x{plan['max_nodes']}x{plan['samples']}, not {P}x{T}x{B}")
    out = torch.empty(P, device=dev)
    lib = _library("gp_eval")
    rc = lib.gp_eval_launch(
        _ptr(genomes), _ptr(ops), _ptr(args), _ptr(length),
        xt.data_ptr(), y.data_ptr(), consts.data_ptr(), fids.data_ptr(),
        out.data_ptr(),
        P, T, B, n_vars, n_consts, n_ops, int(plan["stack_depth"]),
        int(plan["threads_per_program"]), int(plan["programs_per_block"]),
        int(plan["smem_bytes"]),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, lib, "gp_eval")
    LAUNCHES[mode] += 1
    return out
