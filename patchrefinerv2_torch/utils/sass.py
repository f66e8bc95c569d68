"""Instruction counts of a built CUDA library of the port, read from the
toolkit's ``cuobjdump -sass``. For each kernel: its instructions (NOPs left
out), and each innermost loop (a backward branch whose range holds no
other) with its length and how many of its instructions start with each
opcode asked for. Run where the CUDA toolkit is installed (no card needed):

    python -m patchrefinerv2_torch.utils.sass bins MUFU.RCP MUFU.EX2 LDG

builds ``csrc/bins.cu`` if its library is not built yet and prints one JSON
line a kernel.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess


def kernels(name: str) -> dict:
    """{kernel name: [(address, instruction)]} of the library built from
    ``csrc/<name>.cu``, NOPs left out; names demangled where the toolkit
    has ``cu++filt``."""
    from patchrefinerv2_torch.ops import _cuda

    lib = _cuda.build([name])[name]
    tools = os.path.dirname(_cuda.nvcc_path())
    text = subprocess.run([os.path.join(tools, "cuobjdump"), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and cur is not None and not m.group(2).startswith("NOP"):
            cur.append((int(m.group(1), 16), m.group(2)))
    filt = os.path.join(tools, "cu++filt")
    if os.path.exists(filt):
        names = subprocess.run([filt], input="\n".join(funcs), capture_output=True, text=True,
                               timeout=60, check=True).stdout.splitlines()
        funcs = dict(zip(names, funcs.values()))
    return funcs


def _opcode(ins: str) -> str:
    return re.sub(r"^@!?U?P\w+\s+", "", ins)


def summary(ins: list, opcodes: list[str]) -> dict:
    """The kernel's instruction count and its innermost loops: [start, end]
    addresses, length and the count of each opcode prefix in ``opcodes``."""
    loops = []
    for a, t in ins:
        m = re.search(r"\bBRA\S* (0x[0-9a-f]+)", t)
        if m and int(m.group(1), 16) < a:
            loops.append((int(m.group(1), 16), a))
    inner = [lp for lp in loops
             if not any(o != lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]
    out = []
    for lo, hi in inner:
        body = [_opcode(t) for a, t in ins if lo <= a <= hi]
        out.append(dict(range=[hex(lo), hex(hi)], length=len(body),
                        **{op: sum(t.startswith(op) for t in body) for op in opcodes}))
    return dict(instructions=len(ins), **{op: sum(_opcode(t).startswith(op) for _, t in ins)
                                          for op in opcodes}, loops=out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("source", help="a source of ops/_cuda.SOURCES, e.g. bins")
    ap.add_argument("opcodes", nargs="*", help="opcode prefixes to count, e.g. MUFU.RCP")
    args = ap.parse_args(argv)
    for kname, ins in kernels(args.source).items():
        print(json.dumps({"kernel": kname, **summary(ins, args.opcodes)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
