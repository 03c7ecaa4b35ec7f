"""The shared-memory loads and stores in each loop of a kernel library's SASS.

usage: python -m sos_rt_tpu_torch.tools.sass [LIBRARY] [--match TEXT]
           [--same-as OTHER]

Disassembles LIBRARY (default: the ``micro`` library, built first if
needed) with ``cuobjdump -sass`` and prints, for each kernel whose name
holds TEXT, one JSON line with every loop (a backward branch and the
instructions it jumps back over): its shared loads (LDS, LDSM), shared
stores (STS, STSM), global loads and stores, block barriers and
tensor-core instructions (HGMMA, HMMA).  A loop nested in another counts
in both.  The micro tools time each rep's round trip through shared
memory, so every rep loop must issue shared loads and stores
(:func:`rep_loop`).  ``--same-as OTHER`` instead compares the code of
LIBRARY's kernels with OTHER's (:func:`same_code`): e.g. a checkout's
``megastream`` library against its parent's, built alike.
"""
from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import os
import re
import shutil
import subprocess

# opcode prefix -> what it counts as
KINDS = (("LDSM", "lds"), ("LDS", "lds"), ("STSM", "sts"), ("STS", "sts"),
         ("LDG", "ldg"), ("STG", "stg"), ("BAR", "bar"), ("HGMMA", "mma"),
         ("HMMA", "mma"))
_FUNC = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"\bBRA\b.*?(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))")


def cuobjdump() -> str:
    """The cuobjdump of the CUDA toolkit, or the copy Triton ships."""
    path = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if os.path.exists(path):
        return path
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin:
        bundled = os.path.join(os.path.dirname(spec.origin), "backends", "nvidia",
                               "bin", "cuobjdump")
        if os.path.exists(bundled):
            return bundled
    raise FileNotFoundError("cuobjdump not found (CUDA toolkit or Triton)")


def functions(sass: str) -> dict:
    """{mangled name: [(address, instruction text)]} of a ``cuobjdump
    -sass`` listing; a label line maps to the next instruction's address
    (kept under the key ``(name, label)``)."""
    out, labels, name, pending = {}, {}, None, []
    for ln in sass.splitlines():
        m = _FUNC.match(ln)
        if m:
            name, pending = m.group(1), []
            out[name] = []
            continue
        if name is None:
            continue
        m = _LABEL.match(ln)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSN.search(ln)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[(name, lab)] = addr
            pending = []
            out[name].append((addr, m.group(2)))
    for name in out:
        out[name] = (out[name], {lab: a for (n, lab), a in labels.items() if n == name})
    return out


def _opcode(text: str) -> str:
    words = text.split()
    return words[1] if words and words[0].startswith("@") and len(words) > 1 else words[0]


def loops(insns, labels) -> list:
    """[{start, end, lds, sts, ldg, stg, bar, mma}] for every backward branch."""
    found = []
    for addr, text in insns:
        m = _TARGET.search(text)
        if m is None:
            continue
        target = labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)
        if target is None or target > addr:
            continue
        row = {"start": target, "end": addr}
        row.update({kind: 0 for _, kind in KINDS})
        for a, t in insns:
            if target <= a <= addr:
                op = _opcode(t)
                for prefix, kind in KINDS:
                    if op.startswith(prefix):
                        row[kind] += 1
                        break
        found.append(row)
    return found


def rep_loop(rows: list):
    """The widest loop that reads and writes shared memory and touches no
    global memory (a kernel's rep or pass loop), or None."""
    cands = [r for r in rows if r["lds"] and r["sts"] and not r["ldg"] and not r["stg"]]
    return max(cands, key=lambda r: r["end"] - r["start"], default=None)


@functools.lru_cache(maxsize=None)
def disassemble(path: str) -> str:
    """``cuobjdump -sass`` of the library at ``path``."""
    return subprocess.run([cuobjdump(), "-sass", path], capture_output=True, text=True,
                          timeout=300, check=True).stdout


def library_loops(path: str, match: str = "") -> dict:
    """{mangled kernel name: loops} of the library at ``path``."""
    return {name: loops(insns, labels)
            for name, (insns, labels) in functions(disassemble(path)).items()
            if match in name}


def same_code(path: str, other: str, match: str = "") -> dict:
    """Whether the kernels of two libraries compile to the same SASS, byte
    for byte: each kernel's instructions with their addresses, matched by
    body and not by name (a template parameter with a default renames a
    kernel and leaves its code).  Returns {'kernels': [n, n_other],
    'same': bool, 'only_here': [names], 'only_there': [names]}."""
    from collections import Counter

    def local_labels(insns):
        # branch labels are numbered across the library: renumber them
        # in order of first use within the kernel
        names = {}
        sub = lambda m: names.setdefault(m.group(0), f".L{len(names)}")
        return tuple((a, re.sub(r"\.L_x_\d+", sub, t)) for a, t in insns)

    def bodies(p):
        return {name: local_labels(insns) for name, (insns, _) in
                functions(disassemble(p)).items() if match in name}

    here, there = bodies(path), bodies(other)
    left = Counter(here.values()) - Counter(there.values())
    right = Counter(there.values()) - Counter(here.values())
    return {"kernels": [len(here), len(there)], "same": not left and not right,
            "only_here": sorted(n for n, b in here.items() if b in left),
            "only_there": sorted(n for n, b in there.items() if b in right)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("library", nargs="?", help="a built .so (default: the micro library)")
    ap.add_argument("--match", default="", help="keep kernels whose name holds this")
    ap.add_argument("--same-as", help="compare the kernels' code with this library's")
    args = ap.parse_args(argv)
    path = args.library
    if path is None:
        from sos_rt_tpu_torch.ops import cuda_build

        cuda_build.library("micro")
        path = cuda_build._lib_path("micro")
    if args.same_as:
        res = same_code(path, args.same_as, args.match)
        print(json.dumps(res), flush=True)
        return res
    found = library_loops(path, args.match)
    for name, rows in found.items():
        print(json.dumps({"kernel": name, "rep_loop": rep_loop(rows), "loops": rows}),
              flush=True)
    return found


if __name__ == "__main__":
    main()
