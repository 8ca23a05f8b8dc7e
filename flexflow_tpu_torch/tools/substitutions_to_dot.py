"""Render a substitution-rule catalog as Graphviz dot
(flexflow_tpu's tools/substitutions_to_dot.py, the same text).

Each built-in or JSON rule renders as source pattern -> target pattern:
an op of its type rewritten into the sharded form with the parallel ops
its kind implies (channel -> Repartition/Combine on the channel dim,
reduction -> Replicate/Reduce, attribute/expert -> attribute-dim
Repartition + AllToAll boundaries).  A TASO RuleCollection (JSON or
binary .pb) renders each rule's srcOp and dstOp subgraphs side by side,
externals as ellipses.

  python -m flexflow_tpu_torch.tools.substitutions_to_dot [rules.json [limit]] > subs.dot
"""
import sys

KIND_DECOR = {
    "channel": ("Repartition[out-ch]", "Combine[out-ch]"),
    "reduction": ("Replicate", "Reduce"),
    "attribute": ("Repartition[attr]", "AllToAll"),
    "expert": ("Repartition[expert]", "AllToAll"),
}


def to_dot(xfers) -> str:
    lines = [
        "digraph substitutions {",
        "  rankdir=LR;",
        '  node [shape=box, fontname="monospace"];',
    ]
    for i, x in enumerate(xfers):
        pre, post = KIND_DECOR[x.kind]
        src = f"s{i}"
        lines += [
            f'  subgraph cluster_{i} {{ label="{x.name}";',
            f'    {src}_in  [label="{x.op_type.value}"];',
            f'    {src}_pre  [label="{pre}", style=dashed];',
            f'    {src}_op   [label="{x.op_type.value} (sharded: {x.kind})"];',
            f'    {src}_post [label="{post}", style=dashed];',
            f"    {src}_in -> {src}_pre -> {src}_op -> {src}_post;",
            "  }",
        ]
    lines.append("}")
    return "\n".join(lines)


def taso_to_dot(rules, limit=None) -> str:
    """The parsed TASO pattern rules (pcg/taso.py) of a catalog, the
    first `limit` of them."""
    lines = [
        "digraph taso_rules {",
        "  rankdir=LR;",
        '  node [shape=box, fontname="monospace"];',
    ]
    for i, r in enumerate(rules if limit is None else rules[:limit]):
        lines.append(f'  subgraph cluster_{i} {{ label="{r.name}";')
        for side, ops in (("s", r.src_ops), ("d", r.dst_ops)):
            ext_seen = set()
            for j, op in enumerate(ops):
                params = ",".join(f"{k[3:]}={v}" for k, v in op.params)
                lines.append(
                    f'    r{i}{side}{j} [label="{op.type[3:]}'
                    + (f'\\n{params}' if params else "")
                    + ('"];' if side == "s" else '", style=filled, '
                       'fillcolor=lightgrey];')
                )
                for ref in op.inputs:
                    if ref.op_id < 0:
                        ext = f"r{i}{side}x{-ref.op_id}"
                        if ref.op_id not in ext_seen:
                            ext_seen.add(ref.op_id)
                            lines.append(
                                f'    {ext} [label="in{-ref.op_id}", '
                                "shape=ellipse];")
                        lines.append(f"    {ext} -> r{i}{side}{j};")
                    else:
                        lines.append(
                            f"    r{i}{side}{ref.op_id} -> r{i}{side}{j};")
        for m in r.mapped_outputs:
            lines.append(
                f"    r{i}s{m.src_op_id} -> r{i}d{m.dst_op_id} "
                "[style=dotted, constraint=false];")
        lines.append("  }")
    lines.append("}")
    return "\n".join(lines)


def main(argv=None) -> int:
    """`argv` without the program's name (sys.argv[1:] by default): an
    optional rules file and, for a TASO catalog, how many rules to
    render.  The built-in catalog without a file."""
    from ..pcg.substitution import (generate_all_pcg_xfers,
                                    load_substitution_rules)

    argv = sys.argv[1:] if argv is None else list(argv)
    if argv:
        path = argv[0]
        from ..pcg.taso import is_taso_rule_file, parse_rule_collection

        if is_taso_rule_file(path):
            limit = int(argv[1]) if len(argv) > 1 else None
            print(taso_to_dot(parse_rule_collection(path), limit))
            return 0
        xfers = load_substitution_rules(path)
    else:
        xfers = generate_all_pcg_xfers()
    print(to_dot(xfers))
    return 0


if __name__ == "__main__":
    sys.exit(main())
