"""Program debugging dumps (reference: python/paddle/fluid/debugger.py
pprint_program_codes / draw_block_graphviz, net_drawer.py)."""
from __future__ import annotations

from typing import Optional

__all__ = ["pprint_program_codes", "draw_block_graphviz"]


def pprint_program_codes(program) -> str:
    """Readable text dump of every block (the reference renders pseudo
    codes with colors; this is the plain form)."""
    lines = []
    for blk in program.blocks:
        lines.append("// block %d (parent %d)" % (blk.idx, blk.parent_idx))
        for v in blk.vars.values():
            kind = "param" if getattr(v, "trainable", None) is not None else "var"
            lines.append(
                "  %s %s : %s%s %s"
                % (kind, v.name, v.dtype, list(v.shape) if v.shape else "?",
                   "persistable" if v.persistable else "")
            )
        for op in blk.ops:
            outs = ", ".join("%s=%s" % kv for kv in op.outputs.items())
            ins = ", ".join("%s=%s" % kv for kv in op.inputs.items())
            lines.append("  {%s} = %s(%s)" % (outs, op.type, ins))
    text = "\n".join(lines)
    print(text)
    return text


def draw_block_graphviz(block, highlights=None, path: Optional[str] = "./temp.dot") -> str:
    """Emit a graphviz dot file of the op/var graph."""
    lines = ["digraph G {", "  rankdir=TB;"]
    for i, op in enumerate(block.ops):
        lines.append('  op_%d [label="%s", shape=box, style=filled, fillcolor=lightblue];' % (i, op.type))
        for n in op.input_arg_names:
            lines.append('  "%s" -> op_%d;' % (n, i))
        for n in op.output_arg_names:
            lines.append('  op_%d -> "%s";' % (i, n))
    lines.append("}")
    dot = "\n".join(lines)
    if path:
        with open(path, "w") as f:
            f.write(dot)
    return dot
