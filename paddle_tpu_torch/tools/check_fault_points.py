"""Static fault-point guard for the port: source, docs, and tests agree.

The JAX package's ``tools/check_fault_points.py``, pointed at
``paddle_tpu_torch/``.  Every ``faultpoint("...")`` site there must

1. use a name unique to ONE module,
2. be documented in the README port section's "Fault tolerance" catalog
   table (an operator arming ``PADDLE_TPU_FAULTS`` works from it), and
3. be exercised by at least one port test (``tests/test_torch_*.py`` or
   the drill's child, ``tests/torch_train_child.py``).

Conversely, every catalog row must name a fault point that still exists
in the port's source.  Run::

    python -m paddle_tpu_torch.tools.check_fault_points   # exits 1 and prints problems
"""
from __future__ import annotations

import glob
import os
import re
import sys
from typing import Dict, List, Set

from paddle_tpu_torch.tools import PORT_ROOT, REPO_ROOT, readme_subsection

# call sites look like  _faults.active.faultpoint("executor.run", ...)
_SITE_RE = re.compile(r"""\.faultpoint\(\s*["']([a-z0-9_.]+)["']""")
# catalog rows look like  | `executor.run` | ... |
_ROW_RE = re.compile(r"^\|\s*`([a-z0-9_.]+)`\s*\|")
_SECTION = "Fault tolerance"
_TEST_GLOBS = ("tests/test_torch_*.py", "tests/torch_train_child.py")
# the plan's own definition file and these guards (their docstrings show usage)
_EXCLUDE = {os.path.join(PORT_ROOT, "faults", "__init__.py")}
_EXCLUDE_DIR = os.path.join(PORT_ROOT, "tools")


def source_points(root: str) -> Dict[str, Set[str]]:
    """{point name: {repo-relative files using it}}."""
    out: Dict[str, Set[str]] = {}
    for dirpath, _, files in os.walk(os.path.join(root, PORT_ROOT)):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, root)
            if rel in _EXCLUDE or rel.startswith(_EXCLUDE_DIR + os.sep):
                continue
            with open(path) as f:
                for name in _SITE_RE.findall(f.read()):
                    out.setdefault(name, set()).add(rel)
    return out


def documented_points(root: str) -> Set[str]:
    names: Set[str] = set()
    for line in readme_subsection(root, _SECTION):
        m = _ROW_RE.match(line.strip())
        if m and "." in m.group(1):
            names.add(m.group(1))
    return names


def covered_by_tests(root: str) -> Set[str]:
    """Fault-point names mentioned in the port's tests."""
    text = []
    for pattern in _TEST_GLOBS:
        for path in sorted(glob.glob(os.path.join(root, pattern))):
            with open(path) as f:
                text.append(f.read())
    blob = "\n".join(text)
    return {name for name in source_points(root) if name in blob}


def check(repo_root: str = None) -> List[str]:
    root = repo_root or REPO_ROOT
    points = source_points(root)
    problems: List[str] = []
    for name, files in sorted(points.items()):
        if len(files) > 1:
            problems.append(
                "fault point %r is used from multiple modules (%s) — "
                "names are unique per code path" % (name, sorted(files)))
    documented = documented_points(root)
    covered = covered_by_tests(root)
    for name in sorted(set(points) - documented):
        problems.append("fault point %r is not in the README port fault-point catalog" % name)
    for name in sorted(documented - set(points)):
        problems.append("stale README catalog row %r: no such faultpoint() in source" % name)
    for name in sorted(set(points) - covered):
        problems.append("fault point %r has no port test referencing it" % name)
    return problems


def main() -> int:
    problems = check()
    if not problems:
        print("check_fault_points: OK (%d fault points documented and tested)"
              % len(source_points(REPO_ROOT)))
        return 0
    for p in problems:
        print("check_fault_points: %s" % p, file=sys.stderr)
    print("check_fault_points: %d problem(s)" % len(problems), file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
