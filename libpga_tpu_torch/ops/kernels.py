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
the multi-generation kernel of those hooks. The floor harness's cases of
those kernels build in units of their own (:func:`expr_unit`): a harness
unit (one more macro line) holds the harness's masks, and any other
combination of the flags gets a unit keyed by its mask, so the
production unit's text never changes with the harness. ``deme_breed.cu``
does the same for the builtin kernels (:func:`deme_macro`): its
production unit holds the harness's usual masks, a harness unit the
pipelined kernel's stage cases, and any other combination a unit of its
own. Nothing here runs at import time: this module imports on machines
without ``nvcc`` or a card.

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
"islands_expr_multigen_bf16"). The floor harness's ablated launches
(``ablate=`` of every breed wrapper) count apart, so none counts as a
production launch: "ablate_copy" (the copy case, whatever the hooks),
"ablate_breed" (every other ablated launch of the deme kernel),
"ablate_multigen" (of the multi-generation kernel), "ablate_order" and
"ablate_multigen_order" (the order kernels), "ablate_expr",
"ablate_expr_order", "ablate_expr_multigen" and
"ablate_expr_multigen_order" (the expression kernels), "ablate_pipelined"
(the pipelined deme breed's stage cases), and "_bf16"; ``MASK_LAUNCHES``
counts each ablated launch again under ``(name, kernel bitmask)``, and
``CLUSTER_LAUNCHES`` each multi-generation launch on the cluster schedule
again under its name (the one-block schedule's are the rest; the
builtin and the expression multi-generation kernels alike). The
pipelined deme breed (``deme_breed_cuda(pipelined=True)``: ``PGA.run``'s
builtin breed at any sub-block depth wherever a cluster holds the deme,
:func:`pipelined_holds`) counts as
"deme_pipelined" ("islands_deme_pipelined"; and "_bf16"), and the
expression breed on the pipelined schedule (``expr_pipelined_kernel``,
where ``expr_breed_cuda`` routes a shape to it) as "expr_pipelined"
("islands_expr_pipelined", "ablate_expr_pipelined"; and "_bf16") in place
of "expr". A wrapper adds one where it launches its kernel and nowhere
else.

Genomes (and the children, ``out`` and the multi-generation work
buffers, which take the genomes' dtype) are float32 or bfloat16; every
other tensor a kernel takes is float32 (draws, scores, mparams,
coordinates) or integer. The order-crossover kernels take float32 genomes
only, as JAX declines order crossover at bfloat16.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
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
    "ablate_copy": 0, "ablate_breed": 0, "ablate_multigen": 0, "ablate_copy_bf16": 0,
    "ablate_breed_bf16": 0, "ablate_multigen_bf16": 0, "ablate_order": 0,
    "ablate_multigen_order": 0, "ablate_expr": 0, "ablate_expr_bf16": 0, "ablate_expr_order": 0,
    "ablate_expr_multigen": 0, "ablate_expr_multigen_bf16": 0, "ablate_expr_multigen_order": 0,
    "deme_pipelined": 0,
    "islands_deme_pipelined": 0, "deme_pipelined_bf16": 0, "islands_deme_pipelined_bf16": 0,
    "ablate_pipelined": 0, "ablate_pipelined_bf16": 0,
    "expr_pipelined": 0, "islands_expr_pipelined": 0, "expr_pipelined_bf16": 0,
    "islands_expr_pipelined_bf16": 0, "ablate_expr_pipelined": 0,
    "ablate_expr_pipelined_bf16": 0,
}
MASK_LAUNCHES: dict = {}  # (LAUNCHES name, kernel bitmask) -> ablated launches
CLUSTER_LAUNCHES: dict = {}  # LAUNCHES name -> its launches on the multigen cluster schedule
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
# The floor harness's kernel flags and their bits (csrc/breed_core.cuh's
# ABL_*); the other flags are the host's (fused_step.VALID_ABLATE). The
# masks each builtin kernel is built in in the production unit of
# csrc/deme_breed.cu (its dispatch_*_ablate; the order kernels':
# ABLATE_ORDER_MASKS and, at several generations, ABLATE_MULTIGEN_MASKS),
# the pipelined kernel's stage cases of its harness unit, and the masks of
# an expression harness unit (csrc/expr_breed.cu's dispatch_expr_ablate;
# the one-generation kernels take the stage masks among them). Any other
# mask builds a unit of its own (deme_macro, expr_unit).
ABLATE_BITS = {"copy_only": 1, "sel_const": 2, "no_matmul": 4, "no_cross": 8, "no_mut": 16,
               "no_freeze": 32, "no_rank_cube": 64}
ABLATE_FLOOR = 2 | 4 | 8 | 16
ABLATE_DEME_MASKS = (0, 1, 2, 4, 8, 16, ABLATE_FLOOR)
ABLATE_ORDER_MASKS = (0, 2, 4, 8, 16, ABLATE_FLOOR)
ABLATE_MULTIGEN_MASKS = (0, 32, 64, 2, 4, 8, 16, ABLATE_FLOOR)
PIPELINED_HARNESS_MASKS = (2, 4, 8, 16, ABLATE_FLOOR)
EXPR_HARNESS_MASKS = (2, 4, 8, 16, ABLATE_FLOOR, 32, 64)
# The production unit's masks of each builtin kernel (deme_macro's kinds).
DEME_UNIT_MASKS = {"deme": ABLATE_DEME_MASKS, "order": ABLATE_ORDER_MASKS,
                   "multigen": ABLATE_MULTIGEN_MASKS, "pipelined": (0,)}

# The sub-block pipeline's launch plan: csrc/pipe_plan.cuh's constants,
# mirrored by pipelined_plan (tests/test_torch_pipelined_plan.py builds the
# header with the host compiler and holds the two together).
PIPE_MAX_CLUSTER = 8  # the portable cluster size
PIPE_SMEM_LIMIT = SMEM_BLOCK_BYTES - 1024  # a block's, beside its static arrays
PIPE_ALIGN = 128  # each shared-memory region's alignment

_libs: dict = {}
_expr_libs: dict = {}  # (generated source, unit macro) -> built library path
_deme_libs: dict = {}  # deme_breed.cu unit macro -> built library path


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    MASK_LAUNCHES.clear()
    CLUSTER_LAUNCHES.clear()


def _count(name: str, genomes: torch.Tensor, mask: Optional[int] = None,
           cluster: bool = False) -> None:
    """One launch of ``name`` on ``genomes``' gene dtype; an ablated one
    (``mask``, its kernel bitmask) also under ``MASK_LAUNCHES``, one on the
    multi-generation cluster schedule also under ``CLUSTER_LAUNCHES``."""
    name += "_bf16" if genomes.dtype == torch.bfloat16 else ""
    LAUNCHES[name] += 1
    if mask is not None:
        MASK_LAUNCHES[(name, mask)] = MASK_LAUNCHES.get((name, mask), 0) + 1
    if cluster:
        CLUSTER_LAUNCHES[name] = CLUSTER_LAUNCHES.get(name, 0) + 1


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


def _build_unit(stem: str, text: str, verbose: bool) -> Path:
    """Compile the unit ``text`` into ``_build/lib<stem>-<hash>.so``
    unless that file exists; the text is kept beside it as
    ``<stem>-<hash>.cu`` (its includes resolve in ``csrc/``)."""
    digest = _digest(text.encode())
    lib = BUILD / f"lib{stem}-{digest}.so"
    if lib.exists():
        return lib
    BUILD.mkdir(parents=True, exist_ok=True)
    src = BUILD / f"{stem}-{digest}.cu"
    tmp = src.with_suffix(f".{os.getpid()}.tmp")
    tmp.write_text(text)
    os.replace(tmp, src)
    return _compile(src, lib, verbose)


def deme_macro(kernel: str, mask: int) -> str:
    """The macro line of the ``csrc/deme_breed.cu`` unit that holds the
    floor-harness case ``mask`` of a builtin kernel (``kernel``: "deme",
    "order", "multigen" or "pipelined"): none where the production unit
    holds it (``DEME_UNIT_MASKS``), ``DEME_HARNESS`` for the pipelined
    kernel's stage cases (``PIPELINED_HARNESS_MASKS``, one unit), else
    ``DEME_ABLATE_EXTRA`` with the mask (a unit of its own, holding that
    mask in every builtin kernel it has a meaning in)."""
    if mask in DEME_UNIT_MASKS[kernel]:
        return ""
    if kernel == "pipelined" and mask in PIPELINED_HARNESS_MASKS:
        return "#define DEME_HARNESS 1\n"
    return f"#define DEME_ABLATE_EXTRA {int(mask)}u\n"


def deme_unit(macro: str = "") -> str:
    """The text of a ``deme_breed.cu`` unit: the macro line of
    :func:`deme_macro`, then the source; "" is the production unit, the
    source itself."""
    return macro + (CSRC / "deme_breed.cu").read_text()


def build_deme(macro: str = "", verbose: bool = False) -> Path:
    """Compile the ``deme_breed.cu`` unit of ``macro`` (:func:`deme_unit`):
    the production unit as :func:`build` does, any other into
    ``_build/libdeme_breed-<hash>.so`` with its text beside it."""
    if not macro:
        return build("deme_breed", verbose)
    return _build_unit("deme_breed", deme_unit(macro), verbose)


def _unit_macro(ablate: int) -> str:
    """The macro line that picks the unit of a floor-harness mask:
    ``EXPR_HARNESS`` where the mask is one of ``EXPR_HARNESS_MASKS`` (one
    unit holds them all), else ``EXPR_ABLATE_EXTRA`` with the mask (a
    unit of its own); none for 0, the production unit."""
    if ablate in EXPR_HARNESS_MASKS:
        return "#define EXPR_HARNESS 1\n"
    return f"#define EXPR_ABLATE_EXTRA {int(ablate)}u\n" if ablate else ""


def expr_unit(program, ablate: int = 0) -> str:
    """The text of an expression breed's unit: the generated hooks
    (``program.source``), then the template ``csrc/expr_breed.cu``, with
    the macro line of the floor-harness mask ``ablate`` (an
    :func:`expr_ablate_mask`) between them; mask 0 is the production
    unit, which no mask changes."""
    return program.source + "\n" + _unit_macro(ablate) + (CSRC / "expr_breed.cu").read_text()


def build_expr(program, verbose: bool = False, ablate: int = 0) -> Path:
    """Compile an expression breed's unit (``ablate``: of that harness
    mask, :func:`expr_unit`) into ``_build/libexpr_breed-<hash>.so``
    unless that file exists; the unit's text is kept beside it as
    ``expr_breed-<hash>.cu``."""
    return _build_unit("expr_breed", expr_unit(program, ablate), verbose)


def build_all(verbose: bool = False, programs=(), harness=(), deme_units=()) -> dict:
    """Build every kernel source (the templates only through
    ``programs``, expression units from ``ops/expr_cuda.generate``, and
    ``harness``, programs whose floor-harness unit is built too), and the
    ``deme_breed.cu`` units of the macro lines ``deme_units``
    (:func:`deme_macro`), one nvcc per unit, all started together.
    Returns the seconds each unit's build took (0 where its library
    existed), by source name, ``expr_breed[i]`` for ``programs[i]``,
    ``expr_harness[i]`` for ``harness[i]`` or ``deme_unit[i]`` for
    ``deme_units[i]``."""
    names = sorted(p.stem for p in CSRC.glob("*.cu") if p.stem not in TEMPLATES)

    def timed(fn, *args):
        t0 = time.perf_counter()
        fn(*args)
        return time.perf_counter() - t0

    jobs = [(n, build, (n, verbose)) for n in names]
    # One job a unit: two threads of one process building the same unit
    # would share its temporary file.
    units = {}
    for i, p in enumerate(programs):
        units.setdefault((p.source, 0), (f"expr_breed[{i}]", build_expr, (p, verbose)))
    for i, p in enumerate(harness):
        mask = EXPR_HARNESS_MASKS[0]
        units.setdefault((p.source, mask), (f"expr_harness[{i}]", build_expr, (p, verbose, mask)))
    for i, macro in enumerate(deme_units):
        units.setdefault(("deme", macro), (f"deme_unit[{i}]", build_deme, (macro, verbose)))
    jobs += list(units.values())
    with ThreadPoolExecutor(max_workers=max(len(jobs), 1)) as pool:
        futs = {key: pool.submit(timed, fn, *args) for key, fn, args in jobs}
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
                i, i, i, i, i,          # mode, S, D, q, B
                i, i, f,                # sel kind, tournament size, sel param
                i, i, i, i,             # mutate kind, objective id, islands, gene dtype
                ctypes.c_uint, i, i,    # ablate mask, demes and warps per block
                p,                      # stream
            ], i),
            "deme_pipelined_launch": ([
                p, p, p, p, p,          # gin, gout, sout, ranks, mparams
                p, p, p, p, p,          # sel_u, cross, mut_u, gauss, seed
                i, i, i, i, i,          # P, Pp, L, K, G
                i, i, i, i, i,          # mode, S, D, q, B
                i, i, f,                # sel kind, tournament size, sel param
                i, i, i, i,             # mutate kind, objective id, islands, gene dtype
                ctypes.c_uint,          # ablate mask
                p,                      # stream
            ], i),
            "order_breed_launch": ([
                p, p, p, p, p,          # gin, gout, sout, ranks, mparams
                p, p, p, p, p,          # sel_u, fill, mut_u, gauss, seed
                p, i, f,                # coords, C, penalty
                i, i, i, i, i,          # P, Pp, L, K, G
                i, i, f,                # sel kind, tournament size, sel param
                i, i, i,                # mutate kind, objective id, islands
                ctypes.c_uint,          # ablate mask
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
                ctypes.c_uint, i,       # ablate mask, cluster schedule
                p,                      # stream
            ], i),
            "multigen_cluster_plan": ([
                i, i, i, i, i,          # D, K, L, gene bytes, q
                p,                      # out: C, rows, keys sorted, shared bytes
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
                i, i, i, i, i,          # mode, S, D, q, B
                i, i, f,                # sel kind, tournament size, sel param
                i, i, i, i,             # crossover kind, mutate kind, objective id, warps
                i, i,                   # islands, gene dtype
                ctypes.c_uint, i,       # ablate mask, pipelined schedule
                p,                      # stream
            ], i),
            "expr_pipelined_plan": ([
                i, i, i, i, i,          # K, L, gene bytes, q, mutate kind
                p,                      # out: C, rows, child rows, shared bytes
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
                ctypes.c_uint, i,       # ablate mask, cluster schedule
                p,                      # stream
            ], i),
            "expr_multigen_cluster_plan": ([
                i, i, i, i, i, i,       # D, K, L, gene bytes, q, mutate kind
                p,                      # out: C, rows, keys sorted, child rows, shared bytes
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


def ablate_mask(ablate, multigen: bool = False) -> int:
    """The kernel bitmask of the flags ``ablate`` (names; the host's
    flags add nothing): any combination of the stage flags (and, with
    ``multigen``, no_freeze and no_rank_cube), or with copy_only the
    copy's bit alone, as JAX's copy branch returns before any stage runs.
    :func:`deme_macro` names the unit that holds it."""
    flags = set(ablate)
    if not multigen and flags & {"no_freeze", "no_rank_cube"}:
        raise ValueError(f"ablation flag(s) {sorted(flags & {'no_freeze', 'no_rank_cube'})} are"
                         " the multi-generation kernel's")
    if "copy_only" in flags:
        return ABLATE_BITS["copy_only"]
    return sum(ABLATE_BITS.get(f, 0) for f in flags)


def _deme_library(kernel: str, mask: int) -> ctypes.CDLL:
    """The loaded ``deme_breed.cu`` unit that holds ``kernel``'s case
    ``mask`` (:func:`deme_macro`), built at first use."""
    macro = deme_macro(kernel, mask)
    if not macro:
        return _library("deme_breed")
    if macro not in _deme_libs:
        _deme_libs[macro] = build_deme(macro)
    return _library("deme_breed", _deme_libs[macro])


def expr_ablate_mask(ablate, multigen: bool = False) -> int:
    """The kernel bitmask of the flags ``ablate`` for an expression
    kernel, which takes any combination of the stage flags (and, with
    ``multigen``, no_freeze and no_rank_cube): the unit that holds its
    case is picked by :func:`expr_unit`. The copy is deme_breed_kernel's
    whatever the hooks, so copy_only raises here."""
    if "copy_only" in ablate:
        raise ValueError("copy_only launches deme_breed_kernel's copy, not an expression kernel")
    return ablate_mask(ablate, multigen)


@dataclasses.dataclass(frozen=True)
class PipePlan:
    """``deme_pipelined_kernel``'s plan for a deme (``csrc/pipe_plan.cuh``):
    ``C`` blocks a cluster share it; each stages ``rows`` = K / C parent
    rows, in ``chunks`` TMA bulk copies at parity 1 (runs of q rows; at
    parity 0 one run), ``staged`` bytes a deme with the deme's K ranks, in
    ``smem`` bytes of dynamic shared memory (two buffers of rows, two rank
    rows, two row_of_rank arrays, two barriers)."""

    C: int
    rows: int
    chunks: int
    staged: int
    smem: int


@functools.lru_cache(maxsize=None)
def pipelined_plan(K: int, L: int, gene_bytes: int, q: int) -> Optional[PipePlan]:
    """The least cluster of 1, 2, 4 or 8 blocks that holds a deme of ``K``
    rows of ``L`` genes of ``gene_bytes`` each: K / C a power of two and a
    multiple of the ping-pong quantum ``q`` (a power of two) and the
    block's layout within ``PIPE_SMEM_LIMIT``; None where none does
    (``pipe_plan`` in ``csrc/pipe_plan.cuh``, which the launcher uses)."""
    def aligned(n: int) -> int:
        return -(-n // PIPE_ALIGN) * PIPE_ALIGN

    def pow2(n: int) -> bool:
        return n > 0 and n & (n - 1) == 0

    C = 1
    while C <= PIPE_MAX_CLUSTER and pow2(q):
        if K % C == 0 and (K // C) % q == 0 and pow2(K // C):
            rows = K // C
            smem = 2 * aligned(rows * L * gene_bytes) + 4 * aligned(K * 4) + PIPE_ALIGN
            if smem <= PIPE_SMEM_LIMIT:
                return PipePlan(C, rows, rows // q, rows * L * gene_bytes + K * 4, smem)
        C *= 2
    return None


def pipelined_holds(geom, gene_dtype) -> bool:
    """Whether a breed at ``geom`` with builtin hooks launches
    ``deme_pipelined_kernel``: any geometry, at any sub-block depth B >= 1
    and any row map, whose deme a cluster holds (:func:`pipelined_plan`).
    Elsewhere ``deme_breed_kernel`` computes the same function at the same
    geometry."""
    gene_bytes = 2 if gene_dtype == torch.bfloat16 else 4
    return pipelined_plan(geom.K, geom.L, gene_bytes, geom.q) is not None


@dataclasses.dataclass(frozen=True)
class MultigenPlan:
    """The cluster schedule's plan for a group of
    ``multigen_breed_kernel<false>`` (``csrc/mg_plan.cuh``): ``C`` blocks
    a cluster hold it, each ``rows`` of its slots; a block sorts ``sort``
    keys and takes ``smem`` bytes of dynamic shared memory."""

    C: int
    rows: int
    sort: int
    smem: int


@functools.lru_cache(maxsize=None)
def _multigen_plan(D: int, K: int, L: int, gene_bytes: int, q: int) -> Optional[MultigenPlan]:
    out = (ctypes.c_longlong * 4)()
    lib = _library("deme_breed")
    if not lib.multigen_cluster_plan(D, K, L, gene_bytes, q, out):
        return None
    return MultigenPlan(*(int(x) for x in out))


def multigen_cluster_plan(geom, gene_dtype, crossover="uniform") -> Optional[MultigenPlan]:
    """The cluster plan of a ``multigen_breed_kernel`` launch at ``geom``
    on ``gene_dtype`` genes, as ``csrc/mg_plan.cuh`` makes it, read from
    the built production unit of ``csrc/deme_breed.cu``
    (``multigen_cluster_plan``; built at first use); None where the launch
    breeds on the one-block schedule: order crossover (its walk stays
    there) or a group no cluster holds. Both schedules compute the same
    function. ``expr_multigen_kernel``'s plan, with the rows its hooks
    keep, is :func:`expr_multigen_plan`."""
    if crossover == "order":
        return None
    gene_bytes = 2 if gene_dtype == torch.bfloat16 else 4
    return _multigen_plan(geom.D, geom.K, geom.L, gene_bytes, geom.q)


@dataclasses.dataclass(frozen=True)
class ExprPipelinedPlan:
    """``expr_pipelined_kernel``'s plan for a deme (``csrc/expr_plan.cuh``
    over ``csrc/pipe_plan.cuh``): ``C`` blocks a cluster share it, each
    stages ``rows`` = K / C parent rows, every child in flight keeps
    ``child_rows`` rows of L floats, in ``smem`` bytes of dynamic shared
    memory a block."""

    C: int
    rows: int
    child_rows: int
    smem: int


_expr_plans: dict = {}  # (["multigen",] unit key, [D,] K, L, gene bytes, q, mutate id) -> plan


def expr_pipelined_plan(program, geom, gene_dtype, mutate_id: int,
                        ablate: int = 0) -> Optional[ExprPipelinedPlan]:
    """The plan of an ``expr_pipelined_kernel`` launch of ``program``'s
    hooks at ``geom`` on ``gene_dtype`` genes with the builtin mutate id
    ``mutate_id`` (read where no mutation hook replaces it), as
    ``csrc/expr_plan.cuh`` makes it, read from the built unit of the mask
    ``ablate`` (``expr_pipelined_plan``; built at first use); None where
    ``expr_breed_kernel`` breeds the shape: a genome length that is not a
    multiple of 4, or a deme and its children's rows no cluster holds."""
    gene_bytes = 2 if gene_dtype == torch.bfloat16 else 4
    key = (program.source, _unit_macro(ablate), geom.K, geom.L, gene_bytes, geom.q, mutate_id)
    if key not in _expr_plans:
        out = (ctypes.c_longlong * 4)()
        lib = _expr_library(program, ablate)
        held = lib.expr_pipelined_plan(geom.K, geom.L, gene_bytes, geom.q, mutate_id, out)
        _expr_plans[key] = ExprPipelinedPlan(*(int(x) for x in out)) if held else None
    return _expr_plans[key]


def expr_pipelined_holds(program, geom, gene_dtype, mutate_id: int, order: bool = False,
                         ablate: int = 0) -> bool:
    """Whether an expression breed launches ``expr_pipelined_kernel``:
    uniform or expression crossover (order crossover stays on
    ``expr_order_kernel``) at a shape whose plan holds
    (:func:`expr_pipelined_plan`), at any sub-block depth B. Elsewhere
    ``expr_breed_kernel`` computes the same function at the same geometry.
    Decided from the shape alone, before any launch."""
    return not order and expr_pipelined_plan(program, geom, gene_dtype, mutate_id,
                                             ablate) is not None


@dataclasses.dataclass(frozen=True)
class ExprMultigenPlan:
    """The cluster schedule's plan for a group of
    ``expr_multigen_kernel<false>`` (``expr_mg_plan`` of
    ``csrc/expr_plan.cuh`` over ``csrc/mg_plan.cuh``): ``C`` blocks a
    cluster hold it, each ``rows`` of its slots, sorting ``sort`` keys;
    every child in flight keeps ``child_rows`` rows of L floats; ``smem``
    bytes of dynamic shared memory a block."""

    C: int
    rows: int
    sort: int
    child_rows: int
    smem: int


def expr_multigen_plan(program, geom, gene_dtype, mutate_id: int,
                       ablate: int = 0) -> Optional[ExprMultigenPlan]:
    """The cluster plan of an ``expr_multigen_kernel`` launch of
    ``program``'s hooks at ``geom`` on ``gene_dtype`` genes with the builtin
    mutate id ``mutate_id``, as ``csrc/expr_plan.cuh`` makes it, read from
    the built unit of the mask ``ablate`` (``expr_multigen_cluster_plan``;
    built at first use); None where the one-block schedule breeds the
    group: a genome length that is not a multiple of 4, or a group and its
    children's rows no cluster holds."""
    gene_bytes = 2 if gene_dtype == torch.bfloat16 else 4
    key = ("multigen", program.source, _unit_macro(ablate), geom.D, geom.K, geom.L, gene_bytes,
           geom.q, mutate_id)
    if key not in _expr_plans:
        out = (ctypes.c_longlong * 5)()
        lib = _expr_library(program, ablate)
        held = lib.expr_multigen_cluster_plan(geom.D, geom.K, geom.L, gene_bytes, geom.q,
                                              mutate_id, out)
        _expr_plans[key] = ExprMultigenPlan(*(int(x) for x in out)) if held else None
    return _expr_plans[key]


def expr_multigen_holds(program, geom, gene_dtype, mutate_id: int, order: bool = False,
                        ablate: int = 0) -> bool:
    """Whether an expression multigen launch takes the cluster schedule:
    uniform or expression crossover (order crossover walks on one block) at
    a shape whose plan holds the group (:func:`expr_multigen_plan`).
    Elsewhere the one-block schedule computes the same function. Decided
    from the shape alone, before any launch."""
    return not order and expr_multigen_plan(program, geom, gene_dtype, mutate_id,
                                            ablate) is not None


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
    ablate: tuple = (),
    demes_per_block: int = 1,
    warps_per_block: int = 0,
    pipelined: bool = False,
):
    """Launch ``deme_breed_kernel`` (``pipelined``: ``deme_pipelined_kernel``,
    the persistent cluster kernel that ``PGA.run`` takes wherever a
    cluster holds a deme, :func:`pipelined_holds`, and which computes the
    same function) of ``csrc/deme_breed.cu`` on the
    current stream: the kernel counterpart of
    ``fused_step.deme_breed_reference`` (same arguments, uniform
    crossover; float32 or bfloat16 genomes, its float or bf16 case, the
    children in the genomes' dtype). ``ablate`` (flags checked by
    ``fused_step.validate_ablate``) launches a case of the floor harness:
    with "copy_only" the copy whatever the stage flags beside it (not
    pipelined: the copy pins the riffle), ``demes_per_block`` demes and
    ``warps_per_block`` warps per block (0: the breed's 8), ``ranks``
    then the float32 scores each copied row is handed (cohort order,
    (G, K)) and ``out`` may be ``genomes`` under "alias_io"; the
    stage flags, in any combination, from the unit that holds the mask
    (:func:`deme_macro`).
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
    mask = ablate_mask(ablate)
    copy = mask == ABLATE_BITS["copy_only"]
    if pipelined and copy:
        raise ValueError("the pipelined deme breed has no copy: copy_only pins the riffle")
    if demes_per_block < 1 or G % demes_per_block or (demes_per_block > 1 and not copy):
        raise ValueError(f"demes_per_block {demes_per_block}: the copy's, dividing G={G}")
    if not 0 <= warps_per_block <= 8 or (warps_per_block and not copy):
        raise ValueError(f"warps_per_block {warps_per_block}: the copy's, 1 to 8 (0: 8)")
    lead, n = _island_lead(islands)
    gene_id = _check_genomes(genomes, lead + (Pp, L), dev)
    if pipelined and not pipelined_holds(geom, genomes.dtype):
        raise ValueError(f"no cluster of at most {PIPE_MAX_CLUSTER} blocks holds a deme of {K}"
                         f" rows of {L} genes: deme_breed_kernel breeds it"
                         " (fused_step.breed_launcher)")
    _check(ranks, "handed scores" if copy else "ranks", torch.float32 if copy else torch.int32,
           (n * G, K), dev)
    _check(mparams, "mparams", torch.float32, (2,), dev)
    if mutate not in MUTATE_IDS:
        raise ValueError(f"unknown mutate kind {mutate!r}")
    param = resolve_selection(selection, selection_param)
    if out is None:
        out = torch.empty_like(genomes)
    _check(out, "out", genomes.dtype, lead + (Pp, L), dev)
    if out.data_ptr() == genomes.data_ptr() and not (copy and "alias_io" in ablate
                                                      and geom.layout == "contig"):
        raise ValueError("out must not alias genomes: blocks read rows other blocks write")
    sel_u = cross = mut_u = gauss = None
    if copy:
        seed = draws = None  # the copy draws nothing
    elif draws is not None:
        sel_u, cross, mut_u, gauss = draws.sel_u, draws.cross, draws.mut_u, draws.gauss
        _check(sel_u, "sel_u", torch.float32, lead + (G, K, 2), dev)
        _check(cross, "cross", torch.uint8, lead + (G, K, L), dev)
        _check(mut_u, "mut_u", torch.float32, lead + (G, K, 4), dev)
        if mutate == "gaussian":
            _check(gauss, "gauss", torch.float32, lead + (3, G, K, L), dev)
    else:
        _check(seed, "seed", torch.int64, (n,), dev)
    scores = torch.empty(lead + (Pp,), device=dev) if obj_id else None
    lib = _deme_library("pipelined" if pipelined else "deme", mask)
    args = (
        genomes.data_ptr(), out.data_ptr(), _ptr(scores), ranks.data_ptr(),
        mparams.data_ptr(),
        _ptr(sel_u), _ptr(cross), _ptr(mut_u), _ptr(gauss),
        _ptr(seed if draws is None else None),
        geom.P, Pp, L, K, G,
        geom.mode(parity), geom.S, geom.D, geom.q, geom.B,
        SEL_IDS[selection], tournament_size,
        0.0 if param is None else float(param),
        MUTATE_IDS[mutate], int(obj_id), n, gene_id,
    )
    stream = torch.cuda.current_stream(dev).cuda_stream
    if pipelined:
        if genomes.data_ptr() % 16 or ranks.data_ptr() % 16 or out.data_ptr() % 16:
            raise ValueError("the pipelined deme breed stages 16-byte aligned genomes and ranks"
                             " and stores 16-byte aligned children")
        _raise_on(lib.deme_pipelined_launch(*args, mask, stream), lib, "deme_breed")
        if ablate:
            _count("ablate_pipelined", genomes, mask)
        else:
            _count("deme_pipelined" if islands is None else "islands_deme_pipelined", genomes)
        return out, scores
    rc = lib.deme_breed_launch(*args, mask, int(demes_per_block), int(warps_per_block), stream)
    _raise_on(rc, lib, "deme_breed")
    if ablate:
        _count("ablate_copy" if copy else "ablate_breed", genomes, mask)
    else:
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
    ablate: tuple = (),
):
    """Launch ``order_breed_kernel`` of ``csrc/deme_breed.cu`` on the
    current stream: the kernel counterpart of
    ``fused_step.deme_breed_reference(..., crossover="order")`` (same
    arguments; riffle geometry only). Production mode takes ``seed``
    (int64, one element, on the card); injected mode takes ``draws``
    with the ``fill`` plane. ``obj_id`` 3 (fused TSP) takes ``coords``
    (C, 2) float32 on the card and ``penalty``. ``islands`` = I breeds
    I populations in one launch, shaped as :func:`deme_breed_cuda`'s.
    ``ablate`` launches a stage case of the floor harness (any
    combination of the stage flags, from the unit that holds it; no_cross
    walks nothing; the copy is :func:`deme_breed_cuda`'s).
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
    mask = ablate_mask(ablate)
    if mask == ABLATE_BITS["copy_only"]:
        raise ValueError("copy_only launches deme_breed_kernel's copy, not order_breed_kernel")
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
    lib = _deme_library("order", mask)
    rc = lib.order_breed_launch(
        genomes.data_ptr(), out.data_ptr(), _ptr(scores), ranks.data_ptr(),
        mparams.data_ptr(),
        _ptr(sel_u), _ptr(fill), _ptr(mut_u), _ptr(gauss),
        _ptr(seed if draws is None else None),
        _ptr(coords if obj_id == FUSED_TSP else None), C, float(penalty),
        geom.P, Pp, L, K, G,
        SEL_IDS[selection], tournament_size,
        0.0 if param is None else float(param),
        MUTATE_IDS[mutate], int(obj_id), n, mask,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, lib, "deme_breed")
    if ablate:
        _count("ablate_order", genomes, mask)
    else:
        _count("order" if islands is None else "islands_order", genomes)
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


def _multigen_buffers(genomes, out, work, steps: int, cluster: bool):
    """``(out, [work0, work1])``: the children's buffer and the one-block
    schedule's two scratch buffers (made where None and ``steps`` needs
    them: one from 2 steps, two from 3; None where unused, and always on
    the cluster schedule, which keeps a group in shared memory), of the
    genomes' dtype, none aliasing ``genomes`` or each other."""
    dev, shape = genomes.device, tuple(genomes.shape)
    if out is None:
        out = torch.empty_like(genomes)
    _check(out, "out", genomes.dtype, shape, dev)
    if out.data_ptr() == genomes.data_ptr():
        raise ValueError("out must not alias genomes: blocks read rows other blocks write")
    if cluster:
        return out, [None, None]
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
    ablate: tuple = (),
    cluster: Optional[bool] = None,
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
    words (order crossover: the ``fill`` plane). ``cluster`` picks the
    schedule: None the plan's route, decided here from the shape before
    the launch (:func:`multigen_cluster_plan`; what production takes),
    True the cluster schedule (uniform crossover; a group some cluster
    holds, or the launch raises), False the one-block schedule (what
    tests and ``chip_smoke.py`` compare it with). The cluster schedule
    stages 16-byte aligned ``genomes`` and stores 16-byte aligned ``out``
    (else ValueError). ``work`` is a pair of (Pp, L) scratch tensors of
    the one-block schedule (made here when None and ``steps`` needs
    them: one from 2 steps, two from 3; unread on the cluster
    schedule). Returns ``(genomes (Pp, L),
    scores (Pp,))`` in physical row order. ``islands`` = I breeds I
    populations in one launch: genomes, scores, ``out`` and ``work``
    with a leading island axis (I, Pp, L) / (I, Pp), one seed per island
    (I,), injected draws (I, T, ...). ``ablate`` (flags checked by
    ``fused_step.validate_ablate``; uniform or order crossover) launches
    a case of the floor harness: any combination of no_freeze,
    no_rank_cube and the stage flags, from the unit that holds it. Raises
    on bad arguments or a failed launch; never runs anything else in the
    kernel's place."""
    dev = genomes.device
    if dev.type != "cuda":
        raise ValueError("multigen_breed_cuda needs CUDA tensors")
    mask = ablate_mask(ablate, multigen=True)
    if mask == ABLATE_BITS["copy_only"]:
        raise ValueError("the multi-generation kernel has no copy case")
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
    if cluster is None:
        cluster = multigen_cluster_plan(geom, genomes.dtype, crossover) is not None
    out, work = _multigen_buffers(genomes, out, work, steps, cluster)
    if cluster and (genomes.data_ptr() % 16 or out.data_ptr() % 16):
        raise ValueError("the multi-generation cluster schedule stages 16-byte aligned genomes"
                         " and stores 16-byte aligned children")
    draw_steps, (sel_u, cross, fill, mut_u, gauss, tie) = _multigen_draws(
        draws, seed, geom, steps, crossover, mutate, dev, lead)
    s_out = torch.empty(lead + (Pp,), device=dev)
    lib = _deme_library("multigen", mask)
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
        draw_steps, n, gene_id, mask, int(cluster),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, lib, "deme_breed")
    if ablate:
        _count("ablate_multigen_order" if order else "ablate_multigen", genomes, mask, cluster)
    else:
        key = "multigen_order" if order else "multigen"
        _count(key if islands is None else "islands_" + key, genomes, cluster=cluster)
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


def _expr_library(program, ablate: int = 0) -> ctypes.CDLL:
    """The loaded unit of ``program``'s hooks (of the floor-harness mask
    ``ablate``: :func:`expr_unit`), built at first use."""
    key = (program.source, _unit_macro(ablate))
    if key not in _expr_libs:
        _expr_libs[key] = build_expr(program, ablate=ablate)
    return _library("expr_breed", _expr_libs[key])


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
    ablate: tuple = (),
    pipelined: bool = True,
):
    """Launch ``expr_breed_kernel``, ``expr_pipelined_kernel`` (the same
    function on the pipelined schedule: where :func:`expr_pipelined_holds`,
    unless ``pipelined`` is False, which comparisons with
    ``expr_breed_kernel`` pass) or, for order crossover,
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
    Pp)); the constant tables and ``coords`` are shared. ``ablate``
    (stage flags of the floor harness, any combination) launches that
    case from the hooks' harness unit or a unit of its own
    (:func:`expr_unit`). Raises on bad arguments or a failed build or
    launch; never runs anything else in the kernel's place."""
    dev = genomes.device
    if dev.type != "cuda":
        raise ValueError("expr_breed_cuda needs CUDA tensors")
    G, K, L, Pp = geom.G, geom.K, geom.L, geom.Pp
    cross_op, mut_op, obj_id = _expr_hooks(crossover, mutate, objective, obj_id, L, "expr_breed_cuda")
    mask = expr_ablate_mask(ablate)
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
    mut_id = MUTATE_IDS.get(mutate, 0) if mut_op is None else 0
    pipelined = pipelined and expr_pipelined_holds(program, geom, genomes.dtype, mut_id, order,
                                                   mask)
    if pipelined and (genomes.data_ptr() % 16 or ranks.data_ptr() % 16 or out.data_ptr() % 16):
        raise ValueError("the pipelined expression breed stages 16-byte aligned genomes and"
                         " ranks and stores 16-byte aligned children")
    lib = _expr_library(program, mask)
    rc = lib.expr_breed_launch(
        genomes.data_ptr(), out.data_ptr(), _ptr(scores), ranks.data_ptr(),
        mparams.data_ptr(),
        _ptr(sel_u), _ptr(cross), _ptr(fill), _ptr(mut_u), _ptr(gauss), _ptr(xgene), _ptr(xrow),
        _ptr(seed if draws is None else None), program.consts_on(dev).data_ptr(),
        _ptr(coords if C else None), C, float(penalty),
        geom.P, Pp, L, K, G,
        geom.mode(parity), geom.S, geom.D, geom.q, geom.B,
        SEL_IDS[selection], tournament_size,
        0.0 if param is None else float(param),
        CROSS_IDS["order" if order else "uniform"], mut_id,
        int(obj_id), warps, n, gene_id, mask, int(pipelined),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, lib, "expr_breed")
    key = "expr_order" if order else "expr_pipelined" if pipelined else "expr"
    if ablate:
        _count("ablate_" + key, genomes, mask)
    else:
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
    ablate: tuple = (),
    cluster: Optional[bool] = None,
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
    included). ``ablate`` (the floor harness's no_freeze, no_rank_cube
    and stage flags, any combination) launches that case, as
    :func:`expr_breed_cuda`'s. ``cluster`` picks the schedule, as
    :func:`multigen_breed_cuda`'s does: None the plan's route, decided here
    from the shape before the launch (:func:`expr_multigen_holds`: the
    cluster schedule with the eight-lane expression child where
    ``csrc/expr_plan.cuh`` holds the group; what production takes), True
    the cluster schedule (not for order crossover; a group no cluster
    holds raises), False the one-block schedule (``multigen_group``; what
    tests and ``chip_smoke.py`` compare it with; ``work`` as
    :func:`multigen_breed_cuda`'s). The cluster schedule stages 16-byte
    aligned ``genomes`` and stores 16-byte aligned ``out`` (else
    ValueError). Raises on bad arguments or a failed build or launch;
    never runs anything else in the kernel's place."""
    dev = genomes.device
    if dev.type != "cuda":
        raise ValueError("expr_multigen_cuda needs CUDA tensors")
    G, K, L, Pp, D = geom.G, geom.K, geom.L, geom.Pp, geom.D
    cross_op, mut_op, obj_id = _expr_hooks(crossover, mutate, objective, obj_id, L,
                                           "expr_multigen_cuda", multigen=True)
    mask = expr_ablate_mask(ablate, multigen=True)
    order = crossover == "order"
    lead, n = _island_lead(islands)
    steps, gene_id = _multigen_checks(genomes, scores, geom, steps, tournament_size, elitism,
                                      mparams, order, lead)
    param = resolve_selection(selection, selection_param)
    program = expr_cuda.program_for(cross_op, mut_op, objective)
    mut_id = MUTATE_IDS.get(mutate, 0) if mut_op is None else 0
    if cluster is None:
        cluster = expr_multigen_holds(program, geom, genomes.dtype, mut_id, order, mask)
    elif cluster and order:
        raise ValueError("order crossover walks on the one-block schedule (cluster=False)")
    warps = 0 if cluster else expr_warps(K, L, program.obj_rows, D=D, order=order)
    out, work = _multigen_buffers(genomes, out, work, steps, cluster)
    if cluster and (genomes.data_ptr() % 16 or out.data_ptr() % 16):
        raise ValueError("the multi-generation cluster schedule stages 16-byte aligned genomes"
                         " and stores 16-byte aligned children")
    draw_steps, (sel_u, cross, fill, mut_u, gauss, tie) = _multigen_draws(
        draws, seed, geom, steps, None if cross_op is not None else crossover, mutate, dev, lead)
    xgene = xrow = None
    if draws is not None:
        xgene, xrow = _expr_draws(draws, program, lead + (draw_steps,), geom, dev)
    s_out = torch.empty(lead + (Pp,), device=dev)
    lib = _expr_library(program, mask)
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
        CROSS_IDS["order" if order else "uniform"], mut_id,
        int(obj_id), int(elitism), warps, draw_steps, n, gene_id, mask, int(cluster),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, lib, "expr_breed")
    key = "expr_multigen_order" if order else "expr_multigen"
    if ablate:
        _count("ablate_" + key, genomes, mask, cluster)
    else:
        _count(key if islands is None else "islands_" + key, genomes, cluster=cluster)
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
