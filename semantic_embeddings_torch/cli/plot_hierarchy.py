"""CLI: render a class taxonomy as an SVG graph (the port's own copy of the
JAX package's ``cli/plot_hierarchy.py``; host code only).

The original's flags (``plot_hierarchy.py:33-54`` there).  It shelled out
to graphviz through pydot; this writes the SVG directly with a simple
left-to-right tree layout (leaves evenly spaced, parents centered on their
children).

    python -m semantic_embeddings_torch.cli.plot_hierarchy --hierarchy H --out tree.svg
"""

from __future__ import annotations

import argparse
import html

from ..hierarchy import ClassHierarchy

NODE_W, NODE_H = 130, 26
GAP_X, GAP_Y = 60, 8


def _layout(hierarchy):
    """Returns {node: (depth, y)} with leaves stacked in DFS order."""
    roots = [n for n in hierarchy.nodes if not hierarchy.parents.get(n)]
    pos = {}
    next_y = [0]

    def place(node, depth):
        if node in pos:
            return pos[node][1]
        children = hierarchy.children.get(node, [])
        if not children:
            y = next_y[0]
            next_y[0] += NODE_H + GAP_Y
        else:
            ys = [place(c, depth + 1) for c in children]
            y = sum(ys) / len(ys)
        pos[node] = (depth, y)
        return y

    # Iterative wrapper to survive deep hierarchies.
    import sys

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 4 * len(hierarchy.nodes) + 100))
    try:
        for root in sorted(roots, key=str):
            place(root, 0)
    finally:
        sys.setrecursionlimit(old)
    return pos


def plot_hierarchy(hierarchy, filename, class_names=None):
    """Writes an SVG rendering of the taxonomy (left-to-right)."""
    pos = _layout(hierarchy)
    max_depth = max(d for d, _ in pos.values())
    height = max(y for _, y in pos.values()) + NODE_H + 20
    width = (max_depth + 1) * (NODE_W + GAP_X) + 20

    def node_xy(node):
        depth, y = pos[node]
        return 10 + depth * (NODE_W + GAP_X), 10 + y

    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
        f'height="{height}" font-family="sans-serif" font-size="11">'
    ]
    for parent, children in hierarchy.children.items():
        px, py = node_xy(parent)
        for child in children:
            cx, cy = node_xy(child)
            parts.append(
                f'<line x1="{px + NODE_W}" y1="{py + NODE_H / 2}" '
                f'x2="{cx}" y2="{cy + NODE_H / 2}" stroke="#999"/>'
            )
    for node in pos:
        x, y = node_xy(node)
        is_leaf = not hierarchy.children.get(node)
        fill = "#ffffff" if is_leaf else "#eaeaea"
        label = str(class_names[node]) if class_names else str(node)
        parts.append(
            f'<rect x="{x}" y="{y}" width="{NODE_W}" height="{NODE_H}" '
            f'fill="{fill}" stroke="#333" rx="4"/>'
            f'<text x="{x + NODE_W / 2}" y="{y + NODE_H / 2 + 4}" '
            f'text-anchor="middle">{html.escape(label[:22])}</text>'
        )
    parts.append("</svg>")
    with open(filename, "w") as f:
        f.write("".join(parts))


def build_parser():
    parser = argparse.ArgumentParser(
        description="Creates a graphical visualization of a class taxonomy.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--hierarchy", type=str, required=True,
                        help="Path to a file containing parent-child or is-a "
                             "relationships (one per line).")
    parser.add_argument("--is_a", action="store_true", default=False)
    parser.add_argument("--str_ids", action="store_true", default=False)
    parser.add_argument("--class_names", type=str, default=None,
                        help="Text file mapping class labels to names (one "
                             "label-name tuple per line).")
    parser.add_argument("--out", type=str, required=True,
                        help="Filename of the resulting SVG plot.")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    id_type = str if args.str_ids else int
    hierarchy = ClassHierarchy.from_file(
        args.hierarchy, is_a_relations=args.is_a, id_type=id_type
    )
    class_names = None
    if args.class_names:
        class_names = {}
        with open(args.class_names) as f:
            for line in (l.strip() for l in f):
                if line:
                    lbl, name = line.split(maxsplit=1)
                    class_names[id_type(lbl)] = name
    plot_hierarchy(hierarchy, args.out, class_names=class_names)


if __name__ == "__main__":
    main()
