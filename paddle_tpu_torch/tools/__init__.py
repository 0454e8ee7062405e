"""The port's static and offline guards (``python -m
paddle_tpu_torch.tools.<name>``): the JAX package's ``tools/check_*``,
pointed at ``paddle_tpu_torch/``, at the README's port section and at
``tests/test_torch_*.py``."""
import os
import re
from typing import List

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PORT_ROOT = "paddle_tpu_torch"
README = "README.md"
# the README's port section: from this heading to the next level-2 heading
PORT_HEADING = re.compile(r"^## PyTorch/CUDA port")


def readme_subsection(root: str, title: str) -> List[str]:
    """The lines of the README port section's ``### <title>`` subsection
    (to the next ``##`` or ``###`` heading); [] when it is absent."""
    out: List[str] = []
    in_port = in_sub = False
    with open(os.path.join(root, README)) as f:
        for line in f:
            if line.startswith("## "):
                in_port = bool(PORT_HEADING.match(line))
                in_sub = False
                continue
            if in_port and line.startswith("### "):
                in_sub = line[4:].strip().startswith(title)
                continue
            if in_port and in_sub:
                out.append(line)
    return out
