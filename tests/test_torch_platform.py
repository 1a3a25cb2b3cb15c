"""The port's platform modules against the JAX package's, on the CPU:
``util``, ``log``, ``registry`` (the twins of
``tests/test_util_log_registry.py``, its kvstore-server cases aside),
``env`` and ``mxnet_tpu_torch/ENV_VARS.md`` (the twin of
``tests/test_env_docs.py``), ``runtime``'s feature keys, ``misc``,
``libinfo``, ``attribute.AttrScope`` and ``name.Prefix``. Also: every
``MXNET_*`` name in the port's source is a row of ``env.KNOBS``, and the
modules of this slice import neither JAX nor the JAX package.
"""
import ast
import json
import logging
import os
import re
import subprocess
import sys

import pytest

import mxnet_tpu as jmx
from mxnet_tpu import env as jenv
from mxnet_tpu import misc as jmisc
from mxnet_tpu import name as jname
from mxnet_tpu import registry as jregistry
from mxnet_tpu import runtime as jruntime

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import (attribute, env, libinfo, log, misc, name,
                             registry, runtime, util)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "mxnet_tpu_torch")

#: the modules this slice ports
SLICE_MODULES = [
    "utils/locks.py", "telemetry/__init__.py", "telemetry/tracer.py",
    "telemetry/metrics.py", "telemetry/exporter.py", "profiler.py",
    "runtime.py", "env.py", "log.py", "registry.py", "util.py", "misc.py",
    "libinfo.py", "attribute.py", "name.py", "tools/trace_top.py"]


# -- util (tests/test_util_log_registry.py:13-71) ----------------------------

def test_util_np_shape_scope_and_decorator():
    prev = util.is_np_shape()
    with util.np_shape(True):
        assert util.is_np_shape()
        with util.np_shape(False):
            assert not util.is_np_shape()
        assert util.is_np_shape()
    assert util.is_np_shape() == prev

    @util.np_shape(True)
    def inner():
        return util.is_np_shape()

    assert inner() is True
    assert util.is_np_shape() == prev


def test_util_np_array_and_set_np():
    util.set_np(shape=True, array=True)
    assert util.is_np_array() and util.is_np_shape()
    util.reset_np()
    assert not util.is_np_array() and not util.is_np_shape()
    old = util.set_np_shape(True)
    assert util.is_np_shape()
    util.set_np_shape(old)

    @util.use_np
    def both():
        return util.is_np_shape(), util.is_np_array()

    assert both() == (True, True)
    assert (util.is_np_shape(), util.is_np_array()) == (False, False)

    class K:
        pass

    assert util.use_np(K) is K


def test_util_misc_helpers(tmp_path):
    d = tmp_path / "a" / "b"
    util.makedirs(str(d))
    assert d.is_dir()
    util.makedirs(str(d))  # idempotent

    @util.set_module("mxnet_tpu_torch.fake")
    def f():
        pass

    assert f.__module__ == "mxnet_tpu_torch.fake"

    class NoDoc:
        pass

    @util.wraps_safely(NoDoc)
    def g():
        pass

    assert g.__name__ == "NoDoc"
    assert util.get_gpu_count() == 0  # this host has no card
    with pytest.raises(ValueError):
        util.get_gpu_memory(0)


def test_util_surface_is_the_jax_one():
    from mxnet_tpu import util as jutil

    assert sorted(util.__all__) == sorted(jutil.__all__)


# -- log ---------------------------------------------------------------------

def _log_line(mod, tmp_path, tag):
    f = tmp_path / f"{tag}.log"
    lg = mod.get_logger(f"mxtest_{tag}", filename=str(f), level=mod.INFO)
    assert mod.get_logger(f"mxtest_{tag}") is lg and len(lg.handlers) == 1
    assert mod.getLogger(f"mxtest_{tag}") is lg
    lg.info("hello %s", "world")
    for h in lg.handlers:
        h.flush()
    return f.read_text()


def test_log_format_equals_jax(tmp_path):
    from mxnet_tpu import log as jlog

    jtext = _log_line(jlog, tmp_path, "jax")
    ttext = _log_line(log, tmp_path, "port")
    assert ttext[0] == jtext[0] == "I" and "hello world" in ttext
    # same layout: level letter, MMDD HH:MM:SS, pid, path:line] message
    pat = r"I\d{4} \d\d:\d\d:\d\d \d+ .+:\d+\] hello world\n"
    assert re.fullmatch(pat, ttext) and re.fullmatch(pat, jtext)
    assert log.get_logger() is logging.getLogger()  # root untouched
    assert log.WARNING == jlog.WARNING == logging.WARNING


# -- registry ----------------------------------------------------------------

def _registry_script(reg):
    class Base:
        def __init__(self, x=1):
            self.x = x

    register = reg.get_register_func(Base, "thing")
    alias = reg.get_alias_func(Base, "thing")
    create = reg.get_create_func(Base, "thing")

    @register
    class Foo(Base):
        pass

    @alias("bar", "baz")
    class Bar(Base):
        pass

    out = [type(create("foo")).__name__, type(create("bar", x=3)).__name__,
           create("baz").x, create('["foo", {"x": 9}]').x,
           type(create('{"thing": "bar"}')).__name__,
           sorted(reg.get_registry(Base))]
    inst = Foo(7)
    assert create(inst) is inst
    with pytest.raises(AssertionError):
        create("unregistered_name")
    with pytest.warns(UserWarning):
        register(Bar, "foo")
    return out


def test_registry_config_forms_equal_jax():
    assert _registry_script(registry) == _registry_script(jregistry) == \
        ["Foo", "Bar", 1, 9, "Bar", ["bar", "baz", "foo"]]


# -- env and ENV_VARS.md (tests/test_env_docs.py) -----------------------------

def test_env_vars_md_matches_registry():
    with open(os.path.join(PKG, "ENV_VARS.md")) as f:
        committed = f.read()
    assert committed == env.markdown_table(), (
        "mxnet_tpu_torch/ENV_VARS.md is stale: regenerate with "
        "`python -m mxnet_tpu_torch.env > mxnet_tpu_torch/ENV_VARS.md`")


def test_markdown_table_covers_all_knobs():
    table = env.markdown_table()
    for knob in env.KNOBS:
        assert f"`{knob}`" in table


def test_knob_statuses_and_the_jax_names():
    statuses = {s for s, _, _ in env.KNOBS.values()}
    assert statuses == {"wired", "accepted", "unported"}
    # every JAX knob has a row, with the port's own status
    assert set(jenv.KNOBS) <= set(env.KNOBS)
    for knob, (status, consumer, _) in env.KNOBS.items():
        if status == "unported":
            # slice 10b (the deployment chain) is ported: what is left
            # names 9b, 10c or 11
            assert re.search(r"slice (9b|10c|11)\b", consumer), knob
    for knob in ("MXNET_TELEMETRY", "MXNET_TELEMETRY_BUFFER",
                 "MXNET_LOCK_CHECK", "MXNET_FUSED_STEP", "MXNET_SEED",
                 "MXNET_PROFILER_AUTOSTART", "MXNET_COMPILE_CACHE",
                 "MXNET_ARTIFACT_REMOTE", "MXNET_AUTOTUNE",
                 "MXNET_FLEET_VNODES", "MXNET_SHAPE_BUCKETS",
                 "MXNET_CKPT_DIR", "MXNET_CKPT_KEEP", "MXNET_CKPT_ASYNC",
                 "MXNET_RESUME_MAX_RESTARTS"):
        assert env.KNOBS[knob][0] == "wired", knob


def _port_sources():
    for base, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def test_every_knob_the_port_names_is_in_the_table():
    seen = set()
    for path in _port_sources():
        with open(path) as f:
            seen |= {m.rstrip("_") for m in
                     re.findall(r"MXNET_[A-Z0-9_]+", f.read())}
    missing = sorted(k for k in seen if k not in env.KNOBS)
    assert not missing, missing
    assert len(seen) >= 60  # the scan reached the package's readers


def test_env_getters_and_check(monkeypatch, caplog):
    monkeypatch.setenv("MXNET_SERVING_MAX_BATCH", "8")
    monkeypatch.setenv("MXNET_SERVING_SLO_MS", "bad")
    monkeypatch.setenv("MXNET_NO_SUCH_KNOB", "1")
    assert env.get_int("MXNET_SERVING_MAX_BATCH", 32) == 8
    with caplog.at_level(logging.WARNING):
        assert env.get_float("MXNET_SERVING_SLO_MS", 100.0) == 100.0
        unknown = env.check()
    assert "MXNET_NO_SUCH_KNOB" in unknown
    assert not set(unknown) & set(env.KNOBS)
    assert env.get_bool("MXNET_NOT_SET", True) is True
    assert env.get_str("MXNET_NOT_SET") is None
    assert "MXNET_TELEMETRY" in env.describe()


def test_python_m_env_writes_the_table():
    out = subprocess.run([sys.executable, "-m", "mxnet_tpu_torch.env"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout == env.markdown_table()


def test_readme_links_env_vars():
    with open(os.path.join(ROOT, "README.md")) as f:
        assert "mxnet_tpu_torch/ENV_VARS.md" in f.read()


# -- runtime -----------------------------------------------------------------

def test_runtime_feature_keys_are_the_jax_keys():
    tfeat, jfeat = runtime.Features(), jruntime.Features()
    assert list(tfeat) == list(jfeat)
    assert not tfeat.is_enabled("TPU") and not tfeat.is_enabled("XLA")
    assert not tfeat.is_enabled("PALLAS")
    import torch

    assert tfeat.is_enabled("CUDA") == torch.cuda.is_available()
    assert tfeat.is_enabled("DIST_KVSTORE") == \
        torch.distributed.is_available()
    assert tfeat.is_enabled("FUSED_STEP") and tfeat.is_enabled("SERVING")
    assert not tfeat.is_enabled("NO_SUCH_FEATURE")
    assert [f.name for f in runtime.feature_list()] == list(jfeat)
    assert repr(tfeat["PIL"]).startswith("[")
    assert list(libinfo.features()) == list(jfeat)


def test_runtime_follows_the_knobs(monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_STEP", "0")
    monkeypatch.setenv("MXNET_GRAPH_OPT", "1")
    feat = runtime.Features()
    assert not feat.is_enabled("FUSED_STEP")
    assert feat.is_enabled("GRAPH_OPT")


# -- misc, libinfo -----------------------------------------------------------

@pytest.mark.parametrize("step,factor", [(1, 0.5), (3, 0.1), (10, 0.9)])
def test_factor_scheduler_equals_jax(step, factor):
    t, j = misc.FactorScheduler(step, factor), \
        jmisc.FactorScheduler(step, factor)
    t.base_lr = j.base_lr = 0.3
    assert [t(i) for i in range(25)] == [j(i) for i in range(25)]


def test_misc_validation_equals_jax():
    for mod in (misc, jmisc):
        with pytest.raises(ValueError):
            mod.FactorScheduler(0)
        with pytest.raises(ValueError):
            mod.FactorScheduler(2, factor=1.0)
        with pytest.raises(NotImplementedError):
            mod.LearningRateScheduler()(0)


def test_libinfo_paths():
    inc = libinfo.find_include_path()
    assert inc == os.path.join(PKG, "csrc") and os.path.isdir(inc)
    assert any(f.endswith(".cu") for f in os.listdir(inc))
    libs = libinfo.find_lib_path()
    assert isinstance(libs, list)
    assert all(p.endswith(".so") for p in libs)
    assert libinfo.__version__ == mx.__version__


# -- AttrScope and Prefix ----------------------------------------------------

def _attr_graph(pkg):
    sym = pkg.sym
    with pkg.attribute.AttrScope(ctx_group="dev1", __lr_mult__="0.5"):
        x = sym.var("x")
        with pkg.attribute.AttrScope(ctx_group="dev2"):
            y = sym.FullyConnected(x, num_hidden=4, name="fc")
    z = sym.relu(y, name="act")
    w = sym.var("w", attr={"__wd_mult__": "0"})
    return json.loads(sym.Group([z, w]).tojson())


def test_attr_scope_stamps_as_jax():
    got = {n["name"]: n.get("attrs", {}) for n in _attr_graph(mx)["nodes"]}
    ref = {n["name"]: n.get("attrs", {}) for n in _attr_graph(jmx)["nodes"]}
    assert set(got) == set(ref)
    for key in got:
        scoped = {k: v for k, v in ref[key].items()
                  if k in ("ctx_group", "__lr_mult__", "__wd_mult__")}
        assert {k: got[key].get(k) for k in scoped} == scoped, key
    assert got["x"]["ctx_group"] == "dev1"
    assert got["fc"]["ctx_group"] == "dev2"
    assert got["fc"]["__lr_mult__"] == "0.5"
    assert "ctx_group" not in got["act"]
    assert got["w"] == {"__wd_mult__": "0"}
    with pytest.raises(ValueError):
        attribute.AttrScope(ctx_group=1)
    assert mx.AttrScope is attribute.AttrScope


def test_prefix_names_as_jax():
    names = {}
    for key, pkg, nm in (("jax", jmx, jname), ("port", mx, name)):
        with nm.Prefix("blk_"):
            a = pkg.sym.var("data")
            b = pkg.sym.FullyConnected(a, num_hidden=2)
            c = pkg.sym.FullyConnected(b, num_hidden=2, name="head")
        names[key] = sorted(c.list_arguments()) + [c.name]
    assert names["port"] == names["jax"]
    assert "blk_head" in names["port"]


# -- the package rules for this slice ----------------------------------------

def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("rel", SLICE_MODULES)
def test_slice_module_imports_neither_jax_nor_the_jax_package(rel):
    for mod in _imports(os.path.join(PKG, rel)):
        assert mod is None or not (
            mod.split(".")[0] == "jax" or mod == "mxnet_tpu"
            or mod.startswith("mxnet_tpu.")), (rel, mod)


def test_import_sets_seed_and_autostarts_the_profiler(tmp_path):
    code = ("import json, os, sys\n"
            "import mxnet_tpu_torch as mx\n"
            "print(json.dumps([mx.profiler.is_running(),"
            " mx.profiler._config['aggregate_stats'],"
            " sorted(m for m in sys.modules if m.split('.')[0] in"
            " ('jax', 'mxnet_tpu'))]))\n"
            "mx.profiler.stop()\n")
    env_ = dict(os.environ, MXNET_SEED="3", MXNET_PROFILER_AUTOSTART="1",
                MXNET_NO_SUCH_KNOB_X="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=dict(env_, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == \
        [True, True, []]
    assert "MXNET_NO_SUCH_KNOB_X" in out.stderr
