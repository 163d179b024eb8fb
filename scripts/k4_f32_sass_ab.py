"""Whether the f32 instantiations of K4a and K4b (csrc/banded_flash.cu,
csrc/banded_flash_bwd.cu) compile to the same code in two trees: registers,
spills and SASS of every f32 kernel, function by function.

    python3 scripts/k4_f32_sass_ab.py --parent DIR [--out FILE]

DIR is the root of the other tree (the parent commit unpacked by `git
archive`, say).

Builds both trees' banded sources with the port's nvcc flags into a
temporary directory, reads ptxas's report and cuobjdump's SASS, and pairs
the f32 kernels by their template integers (a kernel templated on the
element type carries an `f` in its mangled name; the pairing reads only the
integers).
Prints one line per kernel and one JSON line; exits 1 when an f32 kernel
differs. Needs nvcc and cuobjdump (the CUDA toolkit), no card.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from graph_weather_tpu_torch.ops import _build  # noqa: E402

SOURCES = ("banded_flash", "banded_flash_bwd")


def kernel_key(mangled: str) -> str | None:
    """'<name> <template integers>' of an f32 kernel, None for a bf16 one."""
    if "bfloat16" in mangled:
        return None
    name = re.search(r"(banded_flash(?:_bwd)?_kernel)", mangled)
    return f"{name.group(1) if name else mangled} <" + ", ".join(re.findall(r"Li(\d+)E", mangled)) + ">"


def build(root: Path, name: str, out_dir: Path) -> tuple[dict, dict]:
    """(ptxas lines by kernel, SASS body by kernel) of root's csrc/<name>.cu."""
    so = out_dir / f"{name}.so"
    log = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                          str(root / "graph_weather_tpu_torch" / "csrc" / f"{name}.cu")],
                         capture_output=True, text=True, check=True)
    ptxas, current = {}, None
    for line in (log.stdout + log.stderr).splitlines():
        if "Compiling entry function" in line:
            current = kernel_key(line.split("'")[1])
        elif current and ("registers" in line or "spill" in line):
            ptxas.setdefault(current, []).append(line.split(":", 1)[-1].strip())
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    parts = re.split(r"Function : (\S+)", sass)
    bodies = {}
    for function, body in zip(parts[1::2], parts[2::2]):
        key = kernel_key(function)
        if key is not None:
            # instructions only: drop the address and encoding comments
            bodies[key] = [re.sub(r"/\*[0-9a-f]{4,}\*/", "", ln).strip()
                           for ln in body.splitlines() if re.search(r"/\*[0-9a-f]{4}\*/", ln)]
    return ptxas, bodies


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", required=True, type=Path, help="root of the other tree")
    parser.add_argument("--out", type=Path, default=None, help="also write the JSON line here")
    args = parser.parse_args()
    rows, same = [], True
    with tempfile.TemporaryDirectory() as tmp:
        for name in SOURCES:
            builds = {}
            for label, root in (("parent", args.parent.resolve()), ("change", ROOT)):
                out_dir = Path(tmp) / label
                out_dir.mkdir(exist_ok=True)
                builds[label] = build(root, name, out_dir)
            (p_ptxas, p_sass), (c_ptxas, c_sass) = builds["parent"], builds["change"]
            for key in sorted(p_sass):
                sass_same = p_sass[key] == c_sass.get(key)
                regs_same = p_ptxas.get(key) == c_ptxas.get(key)
                same &= sass_same and regs_same
                rows.append(dict(source=name, kernel=key, ptxas_parent=p_ptxas.get(key),
                                 ptxas_change=c_ptxas.get(key), ptxas_same=regs_same,
                                 sass_same=sass_same, sass_lines=len(p_sass[key])))
                print(f"[k4_f32_ab] {name} {key}: ptxas same {regs_same} ({'; '.join(p_ptxas.get(key, []))}) "
                      f"| SASS same {sass_same} ({len(p_sass[key])} instructions)", flush=True)
    line = json.dumps({"k4_f32_unchanged": same, "kernels": rows})
    print(line)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
