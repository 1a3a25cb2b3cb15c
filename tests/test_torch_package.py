"""Package rules of the PyTorch port, checked on a host with no GPU.

- ``import mxnet_tpu_torch`` loads neither ``jax`` nor ``mxnet_tpu``, and
  no module of the package (nor ``chip_smoke.py``) imports them, nor
  ``onnx`` or ``google.protobuf`` (ONNX goes through the package's codec);
- entry points run on the card by default and raise ``MXNetError``
  when there is none, unless the caller asks for ``cpu()``;
- the kernel wrapper takes its plain version only for CPU tensors, and
  ``kernels/_build.py`` imports without ``nvcc`` and raises when it must build.
"""
import ast
import os
import subprocess
import sys

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.kernels import _build
from mxnet_tpu_torch.models import DecoderBlockLM

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "mxnet_tpu_torch")


def _forbidden(name):
    return name is not None and (
        name.split(".")[0] == "jax" or name == "mxnet_tpu"
        or name.startswith("mxnet_tpu."))


def test_import_loads_neither_jax_nor_the_jax_package():
    code = ("import sys\n"
            "import mxnet_tpu_torch, mxnet_tpu_torch.tools.profile_decode\n"
            "import mxnet_tpu_torch.tools.profile_train\n"
            "import mxnet_tpu_torch.tools.profile_predict\n"
            "import mxnet_tpu_torch.tools.profile_resnet\n"
            "import mxnet_tpu_torch.rtc, mxnet_tpu_torch.operator\n"
            "import mxnet_tpu_torch.gluon.model_zoo.vision\n"
            "import mxnet_tpu_torch.module, mxnet_tpu_torch.rnn\n"
            "import mxnet_tpu_torch.gluon.rnn, mxnet_tpu_torch.executor\n"
            "import mxnet_tpu_torch.tools.profile_module\n"
            "import mxnet_tpu_torch.tools.profile_zoo\n"
            "import mxnet_tpu_torch.tools.zoo_precision\n"
            "import mxnet_tpu_torch.examples.train_gan_toy\n"
            "import mxnet_tpu_torch.examples.train_recommender_mf\n"
            "import mxnet_tpu_torch.tools.profile_ssd\n"
            "import mxnet_tpu_torch.examples.train_ssd_toy\n"
            "import mxnet_tpu_torch.tools.ssd_near_ties\n"
            "import mxnet_tpu_torch.tools.profile_quant\n"
            "import mxnet_tpu_torch.tools.n2_plans\n"
            "import mxnet_tpu_torch.contrib.onnx\n"
            "import mxnet_tpu_torch.gluon.contrib.estimator\n"
            "import mxnet_tpu_torch.monitor, mxnet_tpu_torch.visualization\n"
            "import mxnet_tpu_torch.gluon.model_zoo.model_store\n"
            "import mxnet_tpu_torch.contrib.autograd\n"
            "import mxnet_tpu_torch.contrib.io\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] == 'jax'"
            " or m == 'mxnet_tpu' or m.startswith('mxnet_tpu.')"
            " or m.split('.')[0] == 'onnx'"
            " or m.startswith('google.protobuf'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _python_files():
    for base, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)
    yield os.path.join(ROOT, "chip_smoke.py")


# the modules of the training slice, which the scan below must cover
TRAINING_MODULES = [
    "autograd.py", "initializer.py", "ndarray/ndarray.py",
    "ndarray/registry.py", "ndarray/ops_basic.py", "ndarray/ops_index.py",
    "ndarray/ops_nn.py", "ndarray/ops_optim.py", "gluon/parameter.py",
    "gluon/nn/basic_layers.py", "gluon/loss.py", "gluon/trainer.py",
    "kernels/flash_attention.py", "models/transformer.py",
    "optimizer/optimizer.py", "tools/profile_train.py"]
# and those of the symbolic-serving slice
SYMBOLIC_MODULES = [
    "name.py", "symbol/__init__.py", "symbol/infer.py",
    "analysis/diagnostics.py", "analysis/passes.py", "analysis/graph_opt.py",
    "analysis/fusion.py", "kernels/cost_model.py", "kernels/elementwise.py",
    "kernels/norm_act.py", "kernels/attention.py",
    "kernels/serving_fused.py", "gluon/block.py", "serving/session.py",
    "tools/profile_predict.py"]
# and those of the ResNet-50 slice with the runtime-kernel launcher (K4)
RESNET_MODULES = [
    "rtc.py", "kernels/_nvrtc.py", "operator.py", "gluon/nn/conv_layers.py",
    "gluon/model_zoo/__init__.py", "gluon/model_zoo/vision/__init__.py",
    "gluon/model_zoo/vision/resnet.py", "tools/profile_resnet.py"]
# and those of the decode-serving slice (paged store, graphs, SLO admission,
# repository, HTTP front end)
SERVING_MODULES = [
    "resilience/__init__.py", "resilience/faults.py",
    "resilience/breaker.py", "serving/metrics.py", "serving/admission.py",
    "serving/batcher.py", "serving/state.py", "serving/session.py",
    "serving/repository.py", "serving/server.py", "tools/profile_decode.py"]


# and those of symbolic training and the LSTM word-LM
SYMBOLIC_TRAINING_MODULES = [
    "executor.py", "metric.py", "callback.py", "model.py",
    "ndarray/ops_legacy.py", "module/__init__.py", "module/base_module.py",
    "module/module.py", "module/bucketing_module.py",
    "module/sequential_module.py", "module/python_module.py",
    "rnn/__init__.py", "rnn/rnn_cell.py", "rnn/io.py",
    "gluon/rnn/__init__.py", "gluon/rnn/rnn_cell.py",
    "gluon/rnn/rnn_layer.py", "tools/profile_module.py"]


# and those of the Gluon surface and the vision zoo
GLUON_SURFACE_MODULES = [
    "utils/__init__.py", "gluon/utils.py", "gluon/nn/activations.py",
    "gluon/contrib/__init__.py", "gluon/contrib/nn/__init__.py",
    "gluon/contrib/nn/basic_layers.py", "gluon/model_zoo/vision/alexnet.py",
    "gluon/model_zoo/vision/vgg.py", "gluon/model_zoo/vision/squeezenet.py",
    "gluon/model_zoo/vision/mobilenet.py",
    "gluon/model_zoo/vision/densenet.py",
    "gluon/model_zoo/vision/inception.py", "optimizer/contrib.py",
    "tools/profile_zoo.py", "tools/zoo_precision.py",
    "examples/train_gan_toy.py",
    "examples/train_recommender_mf.py"]


# and those of detection (SSD300-VGG16, the box ops, N1)
DETECTION_MODULES = [
    "ndarray/ops_contrib.py", "ndarray/contrib.py", "kernels/box_nms.py",
    "tools/profile_ssd.py", "examples/train_ssd_toy.py",
    "tools/ssd_near_ties.py"]


# and those of int8 quantization (the ops, the passes, contrib, N2)
QUANTIZATION_MODULES = [
    "ndarray/ops_quant.py", "analysis/quantize.py",
    "contrib/quantization.py", "kernels/int8_conv.py",
    "tools/profile_quant.py", "tools/n2_plans.py"]


# and those of the sparse storage types, the text parsers and the DGL ops
SPARSE_MODULES = [
    "ndarray/sparse.py", "ndarray/ops_dgl.py", "ndarray/shared_mem.py",
    "test_utils.py", "io/image_record.py", "io/io.py",
    "tools/profile_sparse.py"]


# and those of ONNX interchange, the estimator, Monitor, viz, the model
# store and the legacy contrib shims, which need no protobuf either
INTERCHANGE_MODULES = [
    "contrib/onnx/__init__.py", "contrib/onnx/_wire.py",
    "contrib/onnx/mx2onnx.py", "contrib/onnx/onnx2mx.py",
    "gluon/contrib/estimator/__init__.py",
    "gluon/contrib/estimator/estimator.py",
    "gluon/contrib/estimator/event_handler.py", "monitor.py",
    "visualization.py", "gluon/model_zoo/model_store.py",
    "contrib/autograd.py", "contrib/io.py", "contrib/ndarray.py",
    "contrib/symbol.py"]


# and those of the resilience layer's checkpoints
RESILIENCE_MODULES = [
    "resilience/checkpoint.py", "resilience/supervisor.py",
    "pipeline/device_feed.py", "random.py", "gluon/trainer.py",
    "tools/profile_resilience.py"]


def test_no_module_imports_jax_or_the_jax_package():
    offenders = []
    files = list(_python_files())
    assert len(files) > 20
    scanned = {os.path.relpath(f, PKG) for f in files}
    assert set(TRAINING_MODULES) | set(SYMBOLIC_MODULES) | \
        set(RESNET_MODULES) | set(SERVING_MODULES) | \
        set(SYMBOLIC_TRAINING_MODULES) | set(GLUON_SURFACE_MODULES) | \
        set(DETECTION_MODULES) | set(QUANTIZATION_MODULES) | \
        set(SPARSE_MODULES) | set(INTERCHANGE_MODULES) | \
        set(RESILIENCE_MODULES) <= scanned
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            offenders += [f"{os.path.relpath(path, ROOT)}: {n}"
                          for n in names if _forbidden(n) or (
                              n.split(".")[0] == "onnx" or
                              n.startswith("google.protobuf"))]
    assert offenders == []


def test_entry_points_need_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a CUDA device")
    assert mx.current_context() == mx.gpu(0)
    net = DecoderBlockLM(16, embed_dim=8, num_layers=1, num_heads=2,
                         max_len=4)
    with pytest.raises(mx.MXNetError, match="CUDA"):
        net.initialize()
    with pytest.raises(mx.MXNetError, match="CUDA"):
        mx.nd.zeros((2, 2))
    with pytest.raises(mx.MXNetError, match="CUDA"):
        serving.SessionStateStore(net.state_row_shapes(),
                                  net.state_row_dtypes())
    net.initialize(ctx=mx.cpu())
    with pytest.raises(mx.MXNetError, match="CUDA"):
        serving.InferenceSession(
            net, input_shapes=[(1, 1)], input_dtypes=["int32"],
            state_shapes=net.state_row_shapes(),
            state_dtypes=net.state_row_dtypes())
    # a session on the CPU, asked for explicitly, works; a store on
    # another device than the session is refused
    store = serving.SessionStateStore(
        net.state_row_shapes(), net.state_row_dtypes(), max_sessions=2,
        ctx=mx.cpu())
    try:
        sess = serving.InferenceSession(
            net, input_shapes=[(1, 1)], input_dtypes=["int32"],
            state_store=store, buckets=[1], ctx=mx.cpu())
        out, _ = sess.step(onp.zeros((1, 1), "int32"), states=[
            onp.zeros((1,) + s, dt) for s, dt in
            zip(net.state_row_shapes(), net.state_row_dtypes())])
        assert out.shape == (1, 16) and out.context == mx.cpu()
    finally:
        store.close()


def test_cuda_impl_on_cpu_tensors_takes_the_plain_path():
    mx.random.seed(1)
    rows = lambda net: [mx.nd.zeros((2,) + s, ctx=mx.cpu(), dtype=dt)
                        for s, dt in zip(net.state_row_shapes(),
                                         net.state_row_dtypes())]
    outs = []
    for impl in ("cuda", "torch"):
        mx.random.seed(1)
        net = DecoderBlockLM(16, embed_dim=8, num_layers=1, num_heads=2,
                             max_len=4, impl=impl)
        net.initialize(ctx=mx.cpu())
        _build.reset_launch_counts()
        with mx.autograd.pause():
            outs.append(net(mx.nd.array(onp.array([[1], [2]], "int32"),
                                        ctx=mx.cpu()), *rows(net))[0])
        assert _build.launch_counts() == {}
    assert onp.array_equal(outs[0].asnumpy(), outs[1].asnumpy())
    with pytest.raises(ValueError, match="impl"):
        DecoderBlockLM(16, embed_dim=8, num_layers=1, num_heads=2,
                       max_len=4, impl="pallas")


def test_build_module_imports_without_nvcc_and_raises_when_it_must_build(
        tmp_path, monkeypatch):
    assert {"decode_attention", "flash_attention"} <= set(_build.sources())
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(mx.MXNetError, match="nvcc"):
        _build.build_all()


def test_launch_counter_counts_and_resets():
    _build.reset_launch_counts()
    _build.count_launch("k")
    _build.count_launch("k")
    assert _build.launch_counts() == {"k": 2}
    _build.reset_launch_counts()
    assert _build.launch_counts() == {}
