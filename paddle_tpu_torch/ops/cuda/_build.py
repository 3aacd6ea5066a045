"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` compiles on first use into its own shared library
with a plain C interface (`nvcc -gencode arch=compute_90a,code=sm_90a
-std=c++17 -O3 -shared -Xcompiler -fPIC`) and is loaded with `ctypes`.
No PyTorch header is included, so a build takes seconds. Libraries land
in `build/paddle_tpu_torch/` beside the package (listed in
`.gitignore`), named by a hash of their sources and flags: an edited
kernel rebuilds, an unchanged one loads from disk. `build()` starts one
`nvcc` per source, all at once, and waits for every one of them. The
three walk libraries (K6/K7, K9, K10: `WALK_PARTS`) are the exception:
most of their compile time is their ring walk's, so each library's
file is compiled with PTT_WALK_EXTERN beside one `nvcc -c` per
instantiation of the walk's dispatch it calls and dtype of q's
(`csrc/walk_instance.cu` under the library's PTT_WALK_* settings;
libraries of equal settings share one), all at once, and linked; the
build's longest job is then one instantiation at one dtype, a sixth of
a walk library, so the build's jobs fill the host's cores.

Pointers and the stream cross as `ctypes.c_void_p`, integers as
`ctypes.c_int`; a library may hold several C entries (`KERNELS`
maps each library to all of them). Every C entry returns
`cudaGetLastError()` after its launch; `check()` turns a non-zero code
into a `RuntimeError`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import torch

__all__ = ["KERNELS", "POOL_CODES", "BUILD_DIR", "CSRC", "build", "load",
           "check", "dtype_code", "stream_ptr", "checkout_source",
           "build_checkouts", "load_path", "ptxas_report", "turn_order"]

CSRC = Path(__file__).resolve().parent / "csrc"
# <repo>/build/paddle_tpu_torch (the package sits at <repo>/paddle_tpu_torch)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "paddle_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# a walk library's objects: compiled with these, linked with LINK_FLAGS
COMPILE_FLAGS = tuple(f for f in NVCC_FLAGS if f != "-shared") + ("-c",)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared",
              "-Xcompiler", "-fPIC")
# walk library -> the (phase 1, masked) instantiations of `ring_dispatch`
# it calls, each built from csrc/walk_instance.cu, one object for each
# dtype code of q's in WALK_DTYPES (`ring_dispatch_t`)
WALK_PARTS = {"ragged_paged_attention": ((0, 0), (0, 1)),
              "paged_decode_attention": ((0, 0), (0, 1)),
              "grouped_paged_attention": ((1, 0), (0, 0))}
WALK_DTYPES = (0, 1, 2)
# kernel library -> {C entry: its argument types} (restype is c_int)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the flash entries take a pointer to their Params struct, the dtype,
# the device and the stream
_FLASH = [_P, _I, _I, _P]
KERNELS = {
    "layer_norm": {
        "ptt_layer_norm_fwd": [_P] * 4 + [_I, _I, _F, _I, _I, _I, _P],
        "ptt_layer_norm_fwd_plan": [_I] * 5 + [_P],
        "ptt_layer_norm_bwd": [_P] * 8 + [_I, _I, _I, _F, _I, _I, _I, _P],
        "ptt_layer_norm_bwd_plan": [_I] * 5 + [_P],
    },
    "ragged_paged_attention": {
        "ptt_ragged_paged_attention": [_P] * 10 + [_I] * 11 + [_P],
        "ptt_ragged_plan": [_I] * 8 + [_P],
    },
    "paged_decode_attention": {
        "ptt_paged_decode_attention": [_P] * 7 + [_I] * 10 + [_P],
        "ptt_decode_plan": [_I] * 7 + [_P],
    },
    "grouped_paged_attention": {
        "ptt_grouped_phase1": [_P] * 14 + [_I] * 11 + [_P],
        "ptt_grouped_phase2": [_P] * 14 + [_I] * 11 + [_P],
        "ptt_grouped_plan": [_I] * 8 + [_P],
    },
    "paged_scatter": {
        "ptt_paged_scatter_float": [_P] * 6 + [_I] * 10 + [_P],
        "ptt_paged_scatter_e4m3": [_P] * 6 + [_I] * 9 + [_P],
        "ptt_paged_scatter_q8": [_P] * 5 + [_I] * 7 + [_F, _F] + [_I] * 2
                                + [_P],
        "ptt_paged_scatter_q8_pair": [_P] * 8 + [_I] * 7 + [_F, _F]
                                     + [_I] * 2 + [_P],
    },
    "lora_paged": {
        "ptt_lora_delta_paged": [_P] * 6 + [_I] * 8 + [_P],
        "ptt_lora_plan": [_I] * 6 + [_P],
    },
    "greedy_argmax": {
        "ptt_greedy_argmax": [_P, _P] + [_I] * 5 + [_P],
    },
    "flash_attention": {
        "ptt_flash_fwd": _FLASH,
        "ptt_flash_dq": _FLASH,
        "ptt_flash_dkv": _FLASH,
    },
}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the paged KV pools' element codes (csrc/common.cuh `Pool`): q's own
# dtype, int8 codes with f32 scale pools, float8 e4m3
POOL_CODES = {"q": 0, "int8": 1, "e4m3": 2}

# name -> loaded library (a process loads each library once)
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def _hash(srcs, flags) -> str:
    h = hashlib.sha256()
    h.update(" ".join(flags).encode())
    for src in srcs:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _sources(csrc: Path, name: str) -> list:
    """The files kernel library `name`'s build reads in `csrc`."""
    srcs = [csrc / f"{name}.cu"] + sorted(csrc.glob("*.cuh"))
    if _walk_split(csrc, name):
        srcs.append(csrc / "walk_instance.cu")
    return srcs


def _walk_split(csrc: Path, name: str) -> bool:
    """Whether library `name` of the sources in `csrc` builds from parts
    (a checkout from before the split has no walk_instance.cu)."""
    return name in WALK_PARTS and (csrc / "walk_instance.cu").exists()


def _target(name: str) -> Path:
    key = _hash(_sources(CSRC, name), NVCC_FLAGS)
    return BUILD_DIR / f"lib{name}-{key}.so"


def _plan(csrc: Path, name: str, out: Path, part_dir: Path) -> tuple:
    """How library `name` builds from the sources in `csrc` into `out`:
    ({object or library path: its nvcc command}, the link command or
    None). A walk library's instantiations land in `part_dir`, named by
    their sources' and settings' hash, so libraries built together with
    the same walk settings share them."""
    src = csrc / f"{name}.cu"
    if not _walk_split(csrc, name):
        return {out: [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)]}, None
    inst = csrc / "walk_instance.cu"
    # the walk's settings the library's file makes before it includes
    # paged_walk.cuh (K9's PTT_WALK_Q_REGS 0) hold for its instantiations
    defs = re.findall(r"^#define PTT_WALK_(\w+) (\S+)", src.read_text(),
                      re.M)
    own_defs = [f"-DPTT_WALK_{k}={v}" for k, v in defs]
    tag = "".join(f"_{k.lower()}{v}" for k, v in defs)
    key = _hash([inst] + sorted(csrc.glob("*.cuh")), COMPILE_FLAGS)
    own = out.with_name(out.name + ".o")
    jobs = {own: [_nvcc(), *COMPILE_FLAGS, "-DPTT_WALK_EXTERN", "-o",
                  str(own), str(src)]}
    # a checkout from before the dtype split instantiates every dtype in
    # one object
    dtypes = (WALK_DTYPES if "PTT_WALK_DTYPE" in inst.read_text()
              else (None,))
    for p, m in WALK_PARTS[name]:
        for d in dtypes:
            part = "" if d is None else f"_t{d}"
            obj = part_dir / f"walk{p}{m}{part}{tag}-{key}.o"
            jobs[obj] = [_nvcc(), *COMPILE_FLAGS, *own_defs,
                         f"-DPTT_WALK_PHASE1={p}", f"-DPTT_WALK_MASKED={m}",
                         *(() if d is None else (f"-DPTT_WALK_DTYPE={d}",)),
                         "-o", str(obj), str(inst)]
    return jobs, [_nvcc(), *LINK_FLAGS, "-o", str(out), *map(str, jobs)]


def _run_plans(plans: dict, what: str,
               times: Optional[dict] = None) -> Dict[str, str]:
    """Run {key: (jobs, link)} plans: every compile at once (a job shared
    by two plans once), then each plan's link. Returns {key: compiler
    output of its jobs}, and fills `times` with {job: seconds from the
    start to its end} (a job by its file's stem: a library, or walkPM_tD
    for instantiation (P, M) at dtype code D, with the library's walk
    settings after it);
    raises RuntimeError naming a failed command."""
    cmds = {}
    for jobs, _ in plans.values():
        cmds.update(jobs)
    t0 = time.perf_counter()

    def run(cmd):
        res = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        return res, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=max(1, len(cmds))) as pool:
        results = dict(zip(cmds, pool.map(run, cmds.values())))
    done, failed = {}, []
    for out, (res, secs) in results.items():
        done[out] = res.stdout
        if times is not None:
            times[out.name.split("-")[0].split(".")[0]
                  .removeprefix("lib")] = secs
        if res.returncode != 0:
            failed.append(f"{out.name} (nvcc exit {res.returncode}):\n"
                          f"{done[out]}")
    for key, (_, link) in plans.items():
        if link is not None and not failed:
            res = subprocess.run(link, capture_output=True, text=True)
            if res.returncode != 0:
                failed.append(f"{key} link (nvcc exit {res.returncode}):\n"
                              f"{res.stdout}{res.stderr}")
    if failed:
        raise RuntimeError(f"{what} failed: " + "\n".join(failed))
    return {key: "".join(done[out] for out in jobs)
            for key, (jobs, _) in plans.items()}


def build(names: Iterable[str] = tuple(KERNELS),
          times: Optional[dict] = None) -> Dict[str, str]:
    """Compile every named kernel library whose hashed target is
    missing, all `nvcc` processes started together (`_plan`). Returns
    {name: compiler output} (the `-Xptxas -v` register and shared-memory
    report of its sources; empty for a library that was already built);
    `times`, when given, gets each compile's seconds from the start to
    its end. Raises RuntimeError naming the source if any compile
    fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    logs: Dict[str, str] = {}
    plans, targets = {}, {}
    for name in names:
        out = _target(name)
        if out.exists():
            logs[name] = ""
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        plans[name] = _plan(CSRC, name, tmp, BUILD_DIR)
        targets[name] = (tmp, out)
    logs.update(_run_plans(plans, "kernel build", times))
    for tmp, out in targets.values():
        os.replace(tmp, out)   # atomic: a reader never sees half a file
        tmp.with_name(tmp.name + ".o").unlink(missing_ok=True)
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, with every C entry that
    `KERNELS[name]` lists bound, building it first if its hashed target
    is missing."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    target = _target(name)
    if not target.exists():
        build([name])
    lib = _bind(ctypes.CDLL(str(target)), KERNELS[name], strict=True)
    _LIBS[name] = lib
    return lib


def _bind(lib: ctypes.CDLL, table: dict, strict: bool) -> ctypes.CDLL:
    """Bind the C entries of `table` ({entry: argument types}) in `lib`:
    all of them (`strict`), or those `lib` has."""
    for entry, argtypes in table.items():
        if strict or hasattr(lib, entry):
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.ptt_error_string.argtypes = [ctypes.c_int]
    lib.ptt_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str):
    """Raise if a C entry reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err:
        msg = lib.ptt_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def dtype_code(dtype: torch.dtype) -> int:
    try:
        return _DTYPE_CODES[dtype]
    except KeyError:
        raise TypeError(f"no CUDA kernel for dtype {dtype}; "
                        f"supported: {sorted(map(str, _DTYPE_CODES))}")


def stream_ptr(device: torch.device) -> int:
    """The raw cudaStream_t of PyTorch's current stream on `device`."""
    return torch.cuda.current_stream(device).cuda_stream


# -- holding this build against other checkouts (the *_turns scripts) -----

def checkout_source(root, name: str) -> Path:
    """Kernel library `name`'s source in the checkout at `root`."""
    return Path(root) / "paddle_tpu_torch/ops/cuda/csrc" / f"{name}.cu"


def build_checkouts(roots, names, tag: str) -> dict:
    """Compile kernel libraries `names` from each checkout in `roots`
    with this build's flags into `BUILD_DIR/<tag>/<i>/`, all `nvcc`
    processes started together (`_plan`). Returns {(root, name): (path,
    compiler output)}; raises RuntimeError naming a source that
    failed."""
    plans, outs = {}, {}
    for i, root in enumerate(roots):
        for name in names:
            out = BUILD_DIR / tag / str(i) / f"lib{name}.so"
            out.parent.mkdir(parents=True, exist_ok=True)
            csrc = checkout_source(root, name).parent
            plans[root, name] = _plan(csrc, name, out, out.parent)
            outs[root, name] = out
    logs = _run_plans(plans, tag)
    return {key: (outs[key], logs[key]) for key in plans}


def load_path(path, name: str,
              earlier: Optional[dict] = None) -> ctypes.CDLL:
    """The library at `path` (kernel `name` built from some checkout),
    the entries of `KERNELS[name]` that it has bound, with `earlier`
    ({entry: argument types}) in place of entries whose signature this
    build changed."""
    return _bind(ctypes.CDLL(str(path)), {**KERNELS[name], **(earlier or {})},
                 strict=False)


def ptxas_report(log: str, pattern) -> str:
    """ptxas's registers and spill lines for the entry the regular
    expression `pattern` finds in compiler output `log`."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and pattern.search(line):
            return " / ".join(x.strip() for x in lines[i + 1:i + 4])
    return "not found"


def turn_order(others) -> tuple:
    """The turns in which a build is timed against other checkouts:
    this build, the others, the others reversed, this build again (a
    drift of the card's clock over the turns then shows as a difference
    between the two turns of one build)."""
    return ("this", *others, *reversed(others), "this")
