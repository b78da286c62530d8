"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` source is compiled on first use, from the sources in
this checkout only, by ``nvcc`` into a shared library with a plain C
interface (no PyTorch headers: seconds to build, not minutes), and
loaded with ``ctypes``.  A source may hold several kernels' entry points
(``KERNELS`` maps each kernel to its source); its library is built once.
Libraries go to ``<checkout>/build/kernels/``, named by the hash of
their source, of the shared headers (``csrc/*.cuh``) it includes and of
the compiler flags, so an edited source or header rebuilds the libraries
that read it, and a stale library is never loaded.  :func:`build_all` starts one ``nvcc`` per
missing library, all at once, and waits for every one.  A failed build
raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

_CSRC = Path(__file__).resolve().parent / "csrc"
#: <checkout>/src/repro_torch/kernels/_build.py → <checkout>
_ROOT = Path(__file__).resolve().parents[3]

_P, _I = ctypes.c_void_p, ctypes.c_int
_L, _F = ctypes.c_longlong, ctypes.c_float

#: kernel name → (source file, C entry point, argtypes).  Every pointer
#: and the stream are ``c_void_p`` and every stride ``c_longlong``, so
#: ctypes never cuts them to 32 bits.
_FWD = [_P] * 7 + [_I] * 9 + [_P, _I, _P, _P]
_BWD = [_P] * 12 + [_I] * 13 + [_P, _P]
KERNELS: Dict[str, Tuple[str, str, List]] = {
    "treelstm_megastep": (
        "treelstm_megastep_sm90.cu", "treelstm_megastep_sm90_launch", _FWD),
    "scatter_add_rows": (
        "scatter_add_rows.cu", "scatter_add_rows_launch",
        [_P] * 6 + [_I] * 4 + [_L] * 2 + [_P]),
    **{f"{kind}_megastep": ("cell_megastep_sm90.cu",
                            f"{kind}_megastep_sm90_launch", _FWD)
       for kind in ("lstm", "gru", "treefc")},
    **{f"{kind}_bwd_megastep": ("bwd_megastep_sm90.cu",
                                f"{kind}_bwd_megastep_launch", _BWD)
       for kind in ("treelstm", "lstm", "gru", "treefc")},
    "gather_rows": ("gather_scatter.cu", "gather_rows_launch",
                    [_P] * 4 + [_I] * 7 + [_P]),
    "scatter_rows": ("gather_scatter.cu", "scatter_rows_launch",
                     [_P] * 3 + [_I] * 6 + [_P]),
    "lstm_gates": ("cell_gates.cu", "lstm_gates_launch",
                   [_P] * 4 + [_I] * 8 + [_P]),
    "treelstm_gates": ("cell_gates.cu", "treelstm_gates_launch",
                       [_P] * 8 + [_I] * 14 + [_P]),
    "lstm_level_fused": ("cell_megastep_sm90.cu", "lstm_level_fused_launch",
                         [_P] * 7 + [_I] * 7 + [_P]),
    "flash_attention_sm90": ("flash_attention_sm90.cu",
                             "flash_attention_sm90_launch",
                             [_P] * 4 + [_I] * 6 + [_L] * 9 + [_F]
                             + [_I] * 2 + [_P]),
    "flash_attention_tf32": ("flash_attention_tf32.cu",
                             "flash_attention_tf32_launch",
                             [_P] * 4 + [_I] * 6 + [_L] * 9 + [_F]
                             + [_I] * 3 + [_P, _P]),
    "flash_attention_bwd": ("flash_attention_bwd.cu",
                            "flash_attention_bwd_launch",
                            [_P] * 10 + [_I] * 6 + [_L] * 12 + [_F]
                            + [_I] * 2 + [_P]),
    "decode_attention": ("decode_attention.cu", "decode_attention_launch",
                         [_P] * 5 + [_I] * 5 + [_L] * 8 + [_F] + [_I] * 3
                         + [_P]),
    "ssd_chunk_scan": ("ssd_chunk_sm90.cu", "ssd_chunk_sm90_launch",
                       [_P] * 7 + [_I] * 9 + [_L] * 10 + [_I, _P]),
}

#: Plain C helpers beside the kernels, launching nothing: name → (source,
#: C entry point, argtypes), built into their source's library.
HELPERS: Dict[str, Tuple[str, str, List]] = {
    "host_device_pointer": ("gather_scatter.cu", "host_device_pointer",
                            [_P, _P]),
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOADED: Dict[str, ctypes._CFuncPtr] = {}


def build_dir() -> Path:
    return _ROOT / "build" / "kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def includes(path: Path) -> List[Path]:
    """The headers of ``csrc/`` that ``path`` includes, directly or through
    another of them, in sorted order."""
    seen, todo = set(), [path]
    while todo:
        for name in _INCLUDE.findall(todo.pop().read_bytes()):
            header = _CSRC / name.decode()
            if header.is_file() and header not in seen:
                seen.add(header)
                todo.append(header)
    return sorted(seen)


def _entry(name: str) -> Tuple[str, str, List]:
    return KERNELS[name] if name in KERNELS else HELPERS[name]


def library_path(name: str) -> Path:
    """The library that holds the entry point of kernel (or helper)
    ``name``."""
    src = _CSRC / _entry(name)[0]
    h = hashlib.sha256(src.read_bytes())
    for header in includes(src):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{src.stem}-{h.hexdigest()[:12]}.so"


def build_log(name: str) -> str:
    """What ``nvcc -Xptxas -v`` said when ``name`` was built (registers,
    shared memory, spills), or "" if it was built by another process."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all(names: Optional[Iterable[str]] = None) -> List[str]:
    """Build the library of every kernel in ``names`` (default: all) that
    is missing — one ``nvcc`` per source, all started together.  Returns
    the sources built; raises ``RuntimeError`` with the compiler's output
    if any build fails."""
    names = list(KERNELS if names is None else names)
    todo = list({_entry(n)[0]: n for n in names
                 if not library_path(n).exists()}.values())
    if not todo:
        return []
    nvcc = _nvcc()
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = []
    for n in todo:
        out = library_path(n)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / _entry(n)[0])]
        procs.append((n, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for n, out, tmp, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{n}: nvcc exited {p.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return [_entry(n)[0] for n in todo]


def load(name: str) -> ctypes._CFuncPtr:
    """The C entry point of kernel (or helper) ``name``, built on first
    use."""
    fn = _LOADED.get(name)
    if fn is None:
        build_all([name])
        _src, entry, argtypes = _entry(name)
        lib = ctypes.CDLL(str(library_path(name)))
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LOADED[name] = fn
    return fn
