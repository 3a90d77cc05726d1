"""Run the tour notebook (`intro.ipynb` beside this module) without Jupyter.

Run:  python -m qiskit_gym_torch.examples.notebook [--device cpu] [--out DIR]

The code cells' source is read from the notebook's JSON with `json` and
executed in order in one namespace, as a kernel would run them: a cell's
last expression is its value (Jupyter displays it; the command line prints
its repr). The notebook's first code cell sets `DEVICE` (the card), `MODELS`
(the shipped artifacts, only read) and `OUT` (the run root,
`runs/torch/intro_nb` by default); `device=` and `out=` replace `DEVICE` and
`OUT` right after that cell. No exception is caught: a failed cell or assert
ends the run.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import io
import json
import os
import time
from typing import Iterator, List, NamedTuple, Optional, Tuple

NOTEBOOK = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "intro.ipynb")


def read_cells(path: str = NOTEBOOK) -> List[Tuple[str, str]]:
    """(cell type, source) of every cell of the notebook, in order."""
    with open(path) as f:
        nb = json.load(f)
    return [(c["cell_type"], "".join(c["source"])) for c in nb["cells"]]


class CellRun(NamedTuple):
    index: int       # the cell's place among all the notebook's cells
    stdout: str      # what the cell printed
    value: object    # its last expression's value, or None
    seconds: float
    section: str     # the last markdown heading above the cell


def _execute(source: str, ns: dict, name: str):
    """Run `source` in `ns`; return the value of its last statement if that
    is an expression, else None."""
    tree = ast.parse(source, name)
    last = None
    if tree.body and isinstance(tree.body[-1], ast.Expr):
        last = ast.Expression(tree.body.pop().value)
    exec(compile(tree, name, "exec"), ns)
    return None if last is None else eval(compile(last, name, "eval"), ns)


def run_cells(path: str = NOTEBOOK, device: Optional[str] = None,
              out: Optional[str] = None, only=None) -> Iterator[CellRun]:
    """Execute the notebook's code cells (those of `only`, indices among all
    cells, if given) in one namespace and yield each one's run. `device` and
    `out`, where given, replace the `DEVICE` and `OUT` that the first code
    cell sets."""
    ns = {"__name__": "__main__"}
    first, section = True, ""
    for index, (kind, source) in enumerate(read_cells(path)):
        if kind == "markdown":
            section = next((line.lstrip("#").strip()
                            for line in reversed(source.splitlines())
                            if line.startswith("#")), section)
        if kind != "code" or (only is not None and index not in only):
            continue
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            value = _execute(source, ns, f"<cell {index}>")
        seconds = time.perf_counter() - t0
        if first:
            for name, given in (("DEVICE", device), ("OUT", out)):
                if given is not None:
                    if name not in ns:
                        raise KeyError(f"the first code cell sets no {name}")
                    ns[name] = given
            first = False
        yield CellRun(index, buf.getvalue(), value, seconds, section)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="replaces the notebook's DEVICE (\"cuda\")")
    p.add_argument("--out", default=None,
                   help="replaces the notebook's OUT (runs/torch/intro_nb)")
    args = p.parse_args(argv)
    for run in run_cells(device=args.device, out=args.out):
        print(f"--- cell {run.index}, {run.section} ({run.seconds:.2f} s)")
        print(run.stdout, end="")
        if run.value is not None:
            print(repr(run.value))


if __name__ == "__main__":
    main()
