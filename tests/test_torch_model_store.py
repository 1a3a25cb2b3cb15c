"""The model store of the PyTorch port against the JAX package's, on the
CPU (``mxnet_tpu_torch/gluon/model_zoo/model_store.py`` against
``mxnet_tpu/gluon/model_zoo/model_store.py``): twins of
``tests/test_model_store.py``.

The checksum table and the cache layout are the JAX package's. Nothing
is ever fetched: a file missing from the cache raises an error that says
where to put it (the port makes no network call at all). A file staged
under a run-local checksum entry loads through ``pretrained=True`` on
the context asked for, bitwise.
"""
import hashlib
import os

import numpy as onp
import pytest

from mxnet_tpu.gluon.model_zoo import model_store as jstore

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.gluon.model_zoo import model_store, vision

CPU = mx.cpu()


def test_checksum_table_and_short_hashes_equal_jax():
    assert model_store._model_sha1 == jstore._model_sha1
    for name in sorted(jstore._model_sha1):
        assert model_store.short_hash(name) == jstore.short_hash(name)
        assert len(model_store.short_hash(name)) == 8
    with pytest.raises(ValueError):
        model_store.short_hash("not_a_model")


def test_cache_hit_returns_verified_file(tmp_path, monkeypatch):
    payload = b"fake-params-bytes"
    sha = hashlib.sha1(payload).hexdigest()
    monkeypatch.setitem(model_store._model_sha1, "resnet18_v1", sha)
    fname = tmp_path / f"resnet18_v1-{sha[:8]}.params"
    fname.write_bytes(payload)
    got = model_store.get_model_file("resnet18_v1", root=str(tmp_path))
    assert got == str(fname)
    assert model_store.check_sha1(got, sha)


def test_missing_or_mismatched_file_raises_where_to_put_it(tmp_path,
                                                          monkeypatch):
    """Without the file the store raises naming the model, the path and
    the sha1; with a corrupt file there, likewise; nothing is fetched
    (``urllib`` is made to fail if it is reached)."""
    import urllib.request

    def no_network(*args, **kwargs):
        raise AssertionError("the model store reached for the network")

    monkeypatch.setattr(urllib.request, "urlretrieve", no_network)
    monkeypatch.setattr(urllib.request, "urlopen", no_network)
    want = os.path.join(str(tmp_path),
                        f"alexnet-{model_store.short_hash('alexnet')}.params")
    with pytest.raises(RuntimeError) as err:
        model_store.get_model_file("alexnet", root=str(tmp_path))
    assert "alexnet" in str(err.value) and want in str(err.value)
    assert model_store._model_sha1["alexnet"] in str(err.value)
    with open(want, "wb") as f:
        f.write(b"not the released weights")
    with pytest.raises(RuntimeError, match="do not match"):
        model_store.get_model_file("alexnet", root=str(tmp_path))
    assert os.path.exists(want)


def test_root_defaults_to_mxnet_home(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_HOME", str(tmp_path))
    assert model_store.data_dir() == str(tmp_path)
    with pytest.raises(RuntimeError) as err:
        model_store.get_model_file("vgg16")
    assert os.path.join(str(tmp_path), "models") in str(err.value)


def test_pretrained_flag_routes_to_model_store(tmp_path, monkeypatch):
    """Every zoo constructor asks the store for the JAX package's name."""
    monkeypatch.setenv("MXNET_HOME", str(tmp_path))
    asked = []

    def fake_get(name, root=None):
        asked.append((name, root))
        raise RuntimeError("no file in test")

    monkeypatch.setattr(model_store, "get_model_file", fake_get)
    for ctor, expect in [
            (lambda: vision.resnet50_v1(pretrained=True), "resnet50_v1"),
            (lambda: vision.mobilenet1_0(pretrained=True),
             "mobilenet1.0"),
            (lambda: vision.mobilenet_v2_0_5(pretrained=True),
             "mobilenetv2_0.5"),
            (lambda: vision.squeezenet1_1(pretrained=True),
             "squeezenet1.1"),
            (lambda: vision.vgg16_bn(pretrained=True), "vgg16_bn"),
            (lambda: vision.densenet169(pretrained=True), "densenet169"),
            (lambda: vision.inception_v3(pretrained=True),
             "inceptionv3"),
            (lambda: vision.alexnet(pretrained=True), "alexnet"),
            (lambda: vision.get_model("resnet18_v2", pretrained=True,
                                      root="/x"), "resnet18_v2")]:
        with pytest.raises(RuntimeError):
            ctor()
        assert asked[-1][0] == expect
        assert expect in jstore._model_sha1
    assert asked[-1][1] == "/x"


def test_pretrained_loads_a_staged_file_on_the_context(tmp_path,
                                                      monkeypatch):
    """A ``save_parameters`` file staged as ``<name>-<hash>.params`` with
    a run-local checksum loads through ``pretrained=True``: the same
    logits, bitwise, with every parameter on the context asked for."""
    mx.random.seed(0)
    src = vision.squeezenet1_1(classes=13)
    src.initialize(mx.init.Xavier(), ctx=CPU)
    x = nd.array(onp.random.RandomState(0).rand(1, 3, 224, 224)
                 .astype("float32"), ctx=CPU)
    ref = src(x).asnumpy()
    staged = str(tmp_path / "w.params")
    src.save_parameters(staged)
    with open(staged, "rb") as f:
        sha = hashlib.sha1(f.read()).hexdigest()
    monkeypatch.setitem(model_store._model_sha1, "squeezenet1.1", sha)
    os.replace(staged, str(tmp_path / f"squeezenet1.1-{sha[:8]}.params"))
    net = vision.squeezenet1_1(pretrained=True, classes=13, ctx=CPU,
                               root=str(tmp_path))
    for p in net.collect_params().values():
        assert p.data().context == CPU
    assert net(x).asnumpy().tobytes() == ref.tobytes()


def test_purge(tmp_path):
    f = tmp_path / "x-12345678.params"
    f.write_bytes(b"1")
    keep = tmp_path / "notes.txt"
    keep.write_bytes(b"1")
    model_store.purge(str(tmp_path))
    assert not f.exists() and keep.exists()
    model_store.purge(str(tmp_path / "absent"))


def test_structure_checkpoint_roundtrip_zoo(tmp_path):
    """``save_parameters``/``load_parameters`` (the zoo file format)
    restores identical outputs, and the JAX package reads the file."""
    from mxnet_tpu.gluon.model_zoo import vision as jvision

    mx.random.seed(1)
    net = vision.squeezenet1_1(classes=13)
    net.initialize(mx.init.Xavier(), ctx=CPU)
    x = nd.array(onp.random.RandomState(0).rand(1, 3, 224, 224)
                 .astype("float32"), ctx=CPU)
    ref = net(x)
    f = str(tmp_path / "w.params")
    net.save_parameters(f)
    net2 = vision.squeezenet1_1(classes=13)
    net2.load_parameters(f, ctx=CPU)
    onp.testing.assert_allclose(net2(x).asnumpy(), ref.asnumpy(),
                                rtol=1e-5)
    jnet = jvision.squeezenet1_1(classes=13)
    jnet.load_parameters(f)
    got = {k: p.data().asnumpy()
           for k, p in jnet._collect_params_with_prefix().items()}
    for k, p in net._collect_params_with_prefix().items():
        assert got[k].tobytes() == p.data().asnumpy().tobytes(), k
