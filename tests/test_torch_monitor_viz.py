"""``mx.Monitor`` and ``mx.viz`` of the PyTorch port against the JAX
package's, on the CPU (``mxnet_tpu_torch/{monitor,visualization}.py``
against ``mxnet_tpu/{monitor,visualization}.py``): twins of
``tests/test_aux.py::test_monitor_on_block`` and
``::test_visualization_print_summary`` and of
``tests/test_operator_suite5.py::test_monitor_protocol_tic_toc``.

Weights are made by the port from a seed and carried into the JAX
blocks and modules by name (explicit ``prefix=``). The monitors' rows
(step, name, statistic) come in the same order with the same names, and
the statistics agree within 1e-5; ``print_summary`` prints the same text
and returns the same total; ``plot_network`` gives the same graph.
"""
import numpy as onp
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon, nd
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu.gluon.model_zoo import vision as jvision

CPU = mx.cpu()
TOL = 1e-5


def _net(g):
    net = g.nn.HybridSequential(prefix="net_")
    with net.name_scope():
        net.add(g.nn.Dense(8, activation="relu"), g.nn.Dense(2))
    return net


def _twins(make, in_shape):
    mx.random.seed(0)
    tnet = make(gluon)
    tnet.initialize(mx.init.Xavier(), ctx=CPU)
    tnet(nd.zeros(in_shape, ctx=CPU))
    jnet = make(jgluon)
    jp = jnet._collect_params_with_prefix()
    for k, p in tnet._collect_params_with_prefix().items():
        jp[k]._load_init_from(jnd.array(p.data().asnumpy()))
    return tnet, jnet


def _stats(text):
    return onp.array([float(v) for v in text.strip("[]").split()])


def _same_rows(got, want):
    assert [(n, name) for n, name, _ in got] == \
        [(n, name) for n, name, _ in want]
    for (_, name, g), (_, _, w) in zip(got, want):
        onp.testing.assert_allclose(_stats(g), _stats(w), rtol=TOL,
                                    atol=TOL, err_msg=name)


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("hybridize", [False, True])
def test_monitor_on_block_equals_jax(sort, hybridize):
    """Twin of test_monitor_on_block: every child's output is tapped on
    the collecting steps (interval 2), the same rows as the JAX monitor;
    on a hybridized net too (it runs eagerly on those steps); nothing
    after ``uninstall``."""
    tnet, jnet = _twins(_net, (2, 4))
    if hybridize:
        tnet.hybridize()
    x = onp.random.RandomState(1).randn(2, 4).astype("float32")
    rows = {}
    for tag, pkg, net, arr in (("t", mx, tnet, nd.array(x, ctx=CPU)),
                               ("j", jmx, jnet, jnd.array(x))):
        mon = pkg.Monitor(interval=2, pattern=".*", sort=sort)
        mon.install(net)
        got = []
        for _ in range(3):
            mon.tic()
            net(arr)
            got.append(mon.toc())
        mon.uninstall()
        mon.tic()
        net(arr)
        got.append(mon.toc())
        rows[tag] = got
    for t, j in zip(rows["t"], rows["j"]):
        _same_rows(t, j)
    assert [len(r) for r in rows["t"]] == [3, 0, 3, 0], rows["t"]
    names = [name for _, name, _ in rows["t"][0]]
    assert names == sorted(names) if sort else names == [
        "net_dense0.net_dense0_activation0_output0", "net_dense0_output0",
        "net_dense1_output0"]


def test_monitor_stat_func_and_pattern_equal_jax():
    """A custom statistic and a pattern that keeps the second layer."""
    tnet, jnet = _twins(_net, (2, 4))
    x = onp.random.RandomState(2).randn(2, 4).astype("float32")
    rows = {}
    for tag, pkg, net, arr in (("t", mx, tnet, nd.array(x, ctx=CPU)),
                               ("j", jmx, jnet, jnd.array(x))):
        mon = pkg.Monitor(1, stat_func=lambda a: a.abs().max(),
                          pattern=".*dense1")
        mon.install(net)
        mon.tic()
        net(arr)
        rows[tag] = mon.toc()
    assert [name for _, name, _ in rows["t"]] == ["net_dense1_output0"]
    _same_rows(rows["t"], rows["j"])


def test_monitor_protocol_tic_toc_equals_jax(capsys):
    """Twin of test_monitor_protocol_tic_toc: a Module's per-op taps,
    filtered by pattern, gated by the interval, gone after uninstall;
    ``toc_print`` prints the same lines."""
    rows, printed = {}, {}
    w = onp.random.RandomState(3).randn(4, 3).astype("float32")
    b = onp.random.RandomState(4).randn(4).astype("float32")
    for tag, pkg in (("t", mx), ("j", jmx)):
        data = pkg.sym.Variable("data")
        fc = pkg.sym.FullyConnected(data, num_hidden=4, name="fc")
        out = pkg.sym.softmax(fc, name="sm")
        kw = {"context": CPU} if pkg is mx else {}
        mod = pkg.mod.Module(out, data_names=["data"], label_names=None,
                             **kw)
        mod.bind(data_shapes=[("data", (2, 3))], for_training=False)
        mod.init_params()
        mod.set_params({"fc_weight": pkg.nd.array(w, **(
            {"ctx": CPU} if pkg is mx else {})),
            "fc_bias": pkg.nd.array(b, **({"ctx": CPU} if pkg is mx
                                          else {}))}, {})
        mon = pkg.monitor.Monitor(interval=2, pattern="fc.*")
        mod.install_monitor(mon)
        arr = pkg.nd.array(onp.ones((2, 3), "float32"),
                           **({"ctx": CPU} if pkg is mx else {}))
        batch = pkg.io.DataBatch(data=[arr])
        got = []
        mon.tic()
        mod.forward(batch)
        got.append(mon.toc())
        mon.tic()
        mod.forward(batch)
        got.append(mon.toc())
        mon.tic()
        mod.forward(batch)
        capsys.readouterr()
        mon.toc_print()
        printed[tag] = capsys.readouterr().out
        mon.uninstall()
        mon.tic()
        mod.forward(batch)
        got.append(mon.toc())
        rows[tag] = got
    assert rows["t"][1] == [] and rows["t"][2] == []
    assert all(name.startswith("fc") for _, name, _ in rows["t"][0])
    for t, j in zip(rows["t"], rows["j"]):
        _same_rows(t, j)
    tl, jl = printed["t"].splitlines(), printed["j"].splitlines()
    assert [line[:45] for line in tl] == [line[:45] for line in jl]
    assert len(tl) == 1 and tl[0].startswith("Batch:       3 fc_output")


def test_print_summary_text_equals_jax(capsys):
    """Twin of test_visualization_print_summary."""
    out = {}
    for tag, pkg in (("t", mx), ("j", jmx)):
        data = pkg.sym.Variable("data")
        w = pkg.sym.Variable("fc_weight")
        b = pkg.sym.Variable("fc_bias")
        s = pkg.sym.FullyConnected(data, w, b, num_hidden=10, name="fc")
        s = pkg.sym.softmax(s, name="sm")
        capsys.readouterr()
        total = pkg.viz.print_summary(s, shape={"data": (1, 20)})
        out[tag] = (total, capsys.readouterr().out)
    assert out["t"] == out["j"]
    assert out["t"][0] == 20 * 10 + 10
    assert "fc" in out["t"][1] and "Total params" in out["t"][1]


@pytest.mark.parametrize("with_shape", [False, True])
def test_print_summary_of_a_resnet_equals_jax(capsys, with_shape):
    """The table of a traced zoo ResNet (explicit prefix, a fresh
    NameManager in each package), with and without input shapes."""
    text = {}
    for tag, pkg, zoo in (("t", mx, vision), ("j", jmx, jvision)):
        net = zoo.resnet18_v1(classes=10, prefix="r_")
        with pkg.name.NameManager():
            s = net(pkg.sym.var("data"))
        capsys.readouterr()
        total = pkg.viz.print_summary(
            s, shape={"data": (1, 3, 32, 32)} if with_shape else None,
            line_length=100, positions=[0.5, 0.7, 0.8, 1.0])
        text[tag] = (total, capsys.readouterr().out)
    assert text["t"] == text["j"]
    if with_shape:
        assert text["t"][0] > 11_000_000


def test_plot_network_equals_jax():
    pytest.importorskip("graphviz")
    src = {}
    for tag, pkg in (("t", mx), ("j", jmx)):
        data = pkg.sym.Variable("data")
        with pkg.name.NameManager():
            s = pkg.sym.Activation(pkg.sym.FullyConnected(
                data, num_hidden=4, name="fc"), act_type="relu", name="r")
        dots = [pkg.viz.plot_network(s, title="g").source,
                pkg.viz.plot_network(s, hide_weights=False).source]
        src[tag] = dots
    assert src["t"] == src["j"]
    assert "fc_weight" not in src["t"][0] and "fc_weight" in src["t"][1]


def test_monitor_installed_on_an_executor_reads_its_outputs():
    """``install(exe)`` reads the bound executor's outputs at ``toc``, as
    the JAX monitor does (named ``output<i>``), on collecting steps only."""
    w = onp.random.RandomState(5).randn(3, 4).astype("float32")
    x = onp.random.RandomState(6).randn(2, 4).astype("float32")
    rows = {}
    for tag, pkg in (("t", mx), ("j", jmx)):
        kw = {"ctx": CPU} if pkg is mx else {}
        data = pkg.sym.Variable("data")
        s = pkg.sym.Group([
            pkg.sym.FullyConnected(data, pkg.sym.Variable("w"), num_hidden=3,
                                   no_bias=True, name="fc"),
            pkg.sym.tanh(data, name="th")])
        exe = s.bind(CPU if pkg is mx else jmx.cpu(),
                     {"data": pkg.nd.array(x, **kw),
                      "w": pkg.nd.array(w, **kw)})
        mon = pkg.Monitor(2)
        mon.install(exe)
        got = []
        for _ in range(3):
            mon.tic()
            exe.forward()
            got.append(mon.toc())
        rows[tag] = got
    assert [[name for _, name, _ in r] for r in rows["t"]] == \
        [["output0", "output1"], [], ["output0", "output1"]]
    for t, j in zip(rows["t"], rows["j"]):
        _same_rows(t, j)
