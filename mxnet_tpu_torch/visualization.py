"""Network visualization (``mx.viz``; reference:
python/mxnet/visualization.py).

The PyTorch counterpart of ``mxnet_tpu/visualization.py``:
:func:`print_summary` walks the Symbol DAG and prints a table of the
layers with their output shapes and parameter counts, the same text as
the JAX package's; :func:`plot_network` builds a graphviz ``Digraph``
where the ``graphviz`` Python package is installed, and raises
``ImportError`` where it is not, as the JAX one does.
"""
from __future__ import annotations

__all__ = ["print_summary", "plot_network"]


def print_summary(symbol, shape=None, line_length=120, positions=None):
    """Print the layer table of ``symbol``, its output shapes inferred
    from ``shape`` (``{input name: shape}``); returns the parameter total
    (reference: visualization.py print_summary)."""
    positions = positions or [0.44, 0.64, 0.74, 1.0]
    if positions[-1] <= 1:
        positions = [int(line_length * p) for p in positions]

    shapes_by_name = {}
    if shape is not None:
        arg_names = symbol.list_arguments()
        arg_shapes, _, _ = symbol.infer_shape(**shape)
        shapes_by_name.update(dict(zip(arg_names, arg_shapes)))

    order = symbol._walk()
    to_display = ["Layer (type)", "Output Shape", "Param #",
                  "Previous Layer"]

    def print_row(fields):
        line = ""
        for i, f in enumerate(fields):
            line = (line + str(f))[:positions[i] - 1]
            line += " " * (positions[i] - len(line))
        print(line)

    print("_" * line_length)
    print_row(to_display)
    print("=" * line_length)
    total_params = 0
    for node in order:
        if node._op is None and node._group is None:
            continue  # variables are listed as inputs of their consumers
        if node._group is not None:
            continue
        name = node.name or node._op
        inputs = [i.name or (i._op or "?") for i in (node._inputs or [])]
        nparams = 0
        for inp in (node._inputs or []):
            if inp._op is None and inp.name in shapes_by_name and \
                    inp.name != "data" and not inp.name.endswith("label"):
                s = shapes_by_name[inp.name]
                n = 1
                for d in s:
                    n *= d
                nparams += n
        total_params += nparams
        out_shape = ""
        if shape is not None:
            try:
                _, node_out, _ = node.infer_shape_partial(**shape)
                if node_out:
                    out_shape = "x".join(str(d) for d in node_out[0])
            except Exception:  # noqa: BLE001 — an unknown shape prints
                out_shape = "?"  # "?", as in the JAX package's table
        print_row([f"{name} ({node._op})", out_shape, nparams,
                   ", ".join(inputs[:3])])
    print("=" * line_length)
    print(f"Total params: {total_params}")
    print("_" * line_length)
    return total_params


def plot_network(symbol, title="plot", save_format="pdf", shape=None,
                 node_attrs=None, hide_weights=True):
    """A graphviz ``Digraph`` of ``symbol``'s nodes (reference:
    visualization.py plot_network). Needs the ``graphviz`` package."""
    try:
        from graphviz import Digraph
    except ImportError as e:
        raise ImportError(
            "plot_network requires the graphviz python package") from e
    node_attrs = node_attrs or {}
    dot = Digraph(name=title)
    for node in symbol._walk():
        if node._group is not None:
            continue
        name = node.name or str(id(node))
        if node._op is None:
            if hide_weights and name != "data" and \
                    not name.endswith("label"):
                continue
            dot.node(name, label=name, shape="oval")
        else:
            dot.node(name, label=f"{name}\n{node._op}", shape="box",
                     **node_attrs)
        for inp in (node._inputs or []):
            iname = inp.name or str(id(inp))
            if hide_weights and inp._op is None and iname != "data" and \
                    not iname.endswith("label"):
                continue
            dot.edge(iname, name)
    return dot
