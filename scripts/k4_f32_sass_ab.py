"""Whether the f32 instantiations of K4a and K4b (csrc/banded_flash.cu,
csrc/banded_flash_bwd.cu), or of other sources templated on the element
type, compile to the same code in two trees: registers, spills and SASS of
every f32 kernel, function by function.

    python3 scripts/k4_f32_sass_ab.py --parent DIR [--sources NAME ...] [--bf16] [--out FILE]
                                      [--dump DUMP]
    python3 scripts/k4_f32_sass_ab.py --from-dump DUMP [--sources NAME ...] [--bf16]

DIR is the root of the other tree (the parent commit unpacked by `git
archive`, say); NAME a csrc/NAME.cu (default: the banded sources; K3's
backward: clustered_flash_bwd). --bf16 pairs the bf16 kernels too (K3c's
bf16 widths that a change leaves alone); a kernel that only one tree
instantiates is listed and not compared.

Builds both trees' sources with the port's nvcc flags into a temporary
directory, reads ptxas's report and cuobjdump's SASS, and pairs the f32
kernels by their name and template integers (a kernel templated on the
element type carries an `f` in its mangled name; the pairing reads only the
integers).
Prints one line per kernel and one JSON line; exits 1 when an f32 kernel
differs. Needs nvcc and cuobjdump (the CUDA toolkit), no card; --from-dump
compares what a --dump run wrote, without them.
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


BF16 = False  # --bf16: pair the bf16 kernels too


def kernel_key(mangled: str) -> str | None:
    """'<name> <template integers>' of an f32 kernel ('... bf16' for a bf16
    one with --bf16), None for a bf16 one without."""
    bf16 = "bfloat16" in mangled
    if bf16 and not BF16:
        return None
    # the kernel's length-prefixed name (an anonymous namespace's hash of the
    # source's path comes before it)
    name = next((cand for m in re.finditer(r"\d+", mangled) for k in range(len(m.group()))
                 for cand in [mangled[m.end():m.end() + int(m.group()[k:])]]
                 if cand.endswith("_kernel") and re.fullmatch(r"[a-z_]\w*", cand)), mangled)
    return (f"{name} <" + ", ".join(re.findall(r"Li(\d+)E", mangled)) + ">" + (" bf16" if bf16 else ""))


def compile_source(root: Path, name: str, out_dir: Path) -> tuple[str, str]:
    """(ptxas's report, cuobjdump's SASS) of root's csrc/<name>.cu."""
    so = out_dir / f"{name}.so"
    log = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                          str(root / "graph_weather_tpu_torch" / "csrc" / f"{name}.cu")],
                         capture_output=True, text=True, check=True)
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    return log.stdout + log.stderr, sass


def parse(report: str, sass: str) -> tuple[dict, dict]:
    """(ptxas lines by kernel, SASS body by kernel)."""
    ptxas, current = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            current = kernel_key(line.split("'")[1])
        elif current and ("registers" in line or "spill" in line):
            ptxas.setdefault(current, []).append(line.split(":", 1)[-1].strip())
    parts = re.split(r"Function : (\S+)", sass)
    bodies = {}
    for function, body in zip(parts[1::2], parts[2::2]):
        key = kernel_key(function)
        if key is not None:
            # instructions only (addresses of four hex digits and more), each
            # with its encoding: drop the address, close up the spaces (cuobjdump
            # pads the columns to the file's widest instruction, so a kernel
            # added to the file moves them), and number the branch labels within
            # the function (cuobjdump numbers them across the file too)
            lines = [" ".join(re.sub(r"/\*[0-9a-f]{4,}\*/", "", ln).split())
                     for ln in body.splitlines() if re.search(r"/\*[0-9a-f]{4,}\*/", ln)]
            labels = {}
            bodies[key] = [re.sub(r"\.L_x_\d+", lambda m: labels.setdefault(m.group(), f".L{len(labels)}"), ln)
                           for ln in lines]
    return ptxas, bodies


def build(root: Path | None, name: str, out_dir: Path, label: str, dump: Path | None,
          from_dump: Path | None) -> tuple[dict, dict]:
    """parse() of root's csrc/<name>.cu, compiled (and its report and SASS
    written under dump/<label>/), or read from from_dump/<label>/."""
    if from_dump is not None:
        base = from_dump / label
        return parse((base / f"{name}.ptxas.txt").read_text(), (base / f"{name}.sass.txt").read_text())
    report, sass = compile_source(root, name, out_dir)
    if dump is not None:
        (dump / label).mkdir(parents=True, exist_ok=True)
        (dump / label / f"{name}.ptxas.txt").write_text(report)
        (dump / label / f"{name}.sass.txt").write_text(sass)
    return parse(report, sass)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, default=None, help="root of the other tree")
    parser.add_argument("--sources", nargs="+", default=list(SOURCES), help="csrc/NAME.cu to compare")
    parser.add_argument("--bf16", action="store_true", help="pair the bf16 kernels too")
    parser.add_argument("--out", type=Path, default=None, help="also write the JSON line here")
    parser.add_argument("--dump", type=Path, default=None,
                        help="also write each build's ptxas report and SASS under DUMP/{parent,change}/")
    parser.add_argument("--from-dump", type=Path, default=None,
                        help="compare the reports and SASS a --dump run wrote (no nvcc)")
    args = parser.parse_args()
    if (args.parent is None) == (args.from_dump is None):
        parser.error("give --parent or --from-dump")
    global BF16
    BF16 = args.bf16
    rows, same = [], True
    with tempfile.TemporaryDirectory() as tmp:
        for name in args.sources:
            builds = {}
            for label, root in (("parent", args.parent), ("change", ROOT)):
                out_dir = Path(tmp) / label
                out_dir.mkdir(exist_ok=True)
                builds[label] = build(root and root.resolve(), name, out_dir, label, args.dump,
                                      args.from_dump)
            (p_ptxas, p_sass), (c_ptxas, c_sass) = builds["parent"], builds["change"]
            for key in sorted(set(p_sass) ^ set(c_sass)):
                side = "parent" if key in p_sass else "change"
                rows.append(dict(source=name, kernel=key, only_in=side))
                print(f"[k4_f32_ab] {name} {key}: only in the {side}", flush=True)
            for key in sorted(set(p_sass) & set(c_sass)):
                sass_same = p_sass[key] == c_sass.get(key)
                regs_same = p_ptxas.get(key) == c_ptxas.get(key)
                same &= sass_same and regs_same
                rows.append(dict(source=name, kernel=key, ptxas_parent=p_ptxas.get(key),
                                 ptxas_change=c_ptxas.get(key), ptxas_same=regs_same,
                                 sass_same=sass_same, sass_lines=len(p_sass[key])))
                diff = [i for i, (a, b) in enumerate(zip(p_sass[key], c_sass[key])) if a != b]
                first = f"#{diff[0]}: {p_sass[key][diff[0]]} | {c_sass[key][diff[0]]}" if diff else ""
                print(f"[k4_f32_ab] {name} {key}: ptxas same {regs_same} ({'; '.join(p_ptxas.get(key, []))}) "
                      f"| SASS same {sass_same} ({len(p_sass[key])} and {len(c_sass[key])} instructions"
                      + (f", {len(diff)} differ; first difference {first}" if not sass_same else "") + ")",
                      flush=True)
    line = json.dumps({"k4_f32_unchanged": same, "kernels": rows})
    print(line)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
