"""The pretrained-weight store: a local cache of checksummed files.

The PyTorch counterpart of ``mxnet_tpu/gluon/model_zoo/model_store.py``
(reference: python/mxnet/gluon/model_zoo/model_store.py): the same
cache layout, ``$MXNET_HOME/models/<name>-<short hash>.params``, and the
same published checksum table, so a weight file of the reference's
release drops in unchanged. Nothing is downloaded: a file missing from
the cache, or one whose sha1 does not match, raises an error that says
where to put the file. The zoo constructors' ``pretrained=True`` loads
through :func:`get_model_file`.
"""
from __future__ import annotations

import hashlib
import os

__all__ = ["get_model_file", "purge", "short_hash"]

# the published (sha1, name) table of the reference's released weight
# files (model_store.py:29), the JAX package's table
_model_sha1 = {name: checksum for checksum, name in [
    ("44335d1f0046b328243b32a26a4fbd62d9057b45", "alexnet"),
    ("f27dbf2dbd5ce9a80b102d89c7483342cd33cb31", "densenet121"),
    ("b6c8a95717e3e761bd88d145f4d0a214aaa515dc", "densenet161"),
    ("2603f878403c6aa5a71a124c4a3307143d6820e9", "densenet169"),
    ("1cdbc116bc3a1b65832b18cf53e1cb8e7da017eb", "densenet201"),
    ("ed47ec45a937b656fcc94dabde85495bbef5ba1f", "inceptionv3"),
    ("9f83e440996887baf91a6aff1cccc1c903a64274", "mobilenet0.25"),
    ("8e9d539cc66aa5efa71c4b6af983b936ab8701c3", "mobilenet0.5"),
    ("529b2c7f4934e6cb851155b22c96c9ab0a7c4dc2", "mobilenet0.75"),
    ("6b8c5106c730e8750bcd82ceb75220a3351157cd", "mobilenet1.0"),
    ("36da4ff1867abccd32b29592d79fc753bca5a215", "mobilenetv2_1.0"),
    ("e2be7b72a79fe4a750d1dd415afedf01c3ea818d", "mobilenetv2_0.75"),
    ("aabd26cd335379fcb72ae6c8fac45a70eab11785", "mobilenetv2_0.5"),
    ("ae8f9392789b04822cbb1d98c27283fc5f8aa0a7", "mobilenetv2_0.25"),
    ("a0666292f0a30ff61f857b0b66efc0228eb6a54b", "resnet18_v1"),
    ("48216ba99a8b1005d75c0f3a0c422301a0473233", "resnet34_v1"),
    ("0aee57f96768c0a2d5b23a6ec91eb08dfb0a45ce", "resnet50_v1"),
    ("d988c13d6159779e907140a638c56f229634cb02", "resnet101_v1"),
    ("671c637a14387ab9e2654eafd0d493d86b1c8579", "resnet152_v1"),
    ("a81db45fd7b7a2d12ab97cd88ef0a5ac48b8f657", "resnet18_v2"),
    ("9d6b80bbc35169de6b6edecffdd6047c56fdd322", "resnet34_v2"),
    ("ecdde35339c1aadbec4f547857078e734a76fb49", "resnet50_v2"),
    ("18e93e4f48947e002547f50eabbcc9c83e516aa6", "resnet101_v2"),
    ("f2695542de38cf7e71ed58f02893d82bb409415e", "resnet152_v2"),
    ("264ba4970a0cc87a4f15c96e25246a1307caf523", "squeezenet1.0"),
    ("33ba0f93753c83d86e1eb397f38a667eaf2e9376", "squeezenet1.1"),
    ("dd221b160977f36a53f464cb54648d227c707a05", "vgg11"),
    ("ee79a8098a91fbe05b7a973fed2017a6117723a8", "vgg11_bn"),
    ("6bc5de58a05a5e2e7f493e2d75a580d83efde38c", "vgg13"),
    ("7d97a06c3c7a1aecc88b6e7385c2b373a249e95e", "vgg13_bn"),
    ("e660d4569ccb679ec68f1fd3cce07a387252a90a", "vgg16"),
    ("7f01cf050d357127a73826045c245041b0df7363", "vgg16_bn"),
    ("ad2f660d101905472b83590b59708b71ea22b2e5", "vgg19"),
    ("f360b758e856f1074a85abd5fd873ed1d98297c3", "vgg19_bn"),
]}



def data_dir():
    """``$MXNET_HOME``, default ``~/.mxnet``."""
    from ... import env as _env

    return _env.get_str(
        "MXNET_HOME", os.path.join(os.path.expanduser("~"), ".mxnet"))


def short_hash(name):
    """The first eight hex digits of ``name``'s published sha1."""
    if name not in _model_sha1:
        raise ValueError(f"Pretrained model for {name} is not available.")
    return _model_sha1[name][:8]


def check_sha1(filename, sha1_hash):
    """Whether the file's sha1 is ``sha1_hash`` (reference:
    gluon/utils.py check_sha1)."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            sha1.update(chunk)
    return sha1.hexdigest() == sha1_hash


def get_model_file(name, root=None):
    """The path of ``name``'s weight file in the cache under ``root``
    (default ``$MXNET_HOME/models``), checked against its published sha1
    (reference: model_store.py get_model_file, whose cache it reads).

    Raises :class:`RuntimeError` naming the path and the sha1 the file
    must have when it is missing or does not match: nothing is fetched."""
    root = os.path.expanduser(root or os.path.join(data_dir(), "models"))
    file_name = f"{name}-{short_hash(name)}"
    file_path = os.path.join(root, file_name + ".params")
    sha1_hash = _model_sha1[name]
    if os.path.exists(file_path):
        if check_sha1(file_path, sha1_hash):
            return file_path
        raise RuntimeError(
            f"the pretrained weights for '{name}' at {file_path} do not "
            f"match their sha1 {sha1_hash}; nothing is downloaded: put "
            f"the released file there")
    raise RuntimeError(
        f"no pretrained weights for '{name}' in the model store; nothing "
        f"is downloaded: put the file at {file_path} (sha1 {sha1_hash})")


def purge(root=None):
    """Delete the cached weight files under ``root`` (default
    ``$MXNET_HOME/models``) (reference: model_store.py purge)."""
    root = os.path.expanduser(root or os.path.join(data_dir(), "models"))
    if not os.path.isdir(root):
        return
    for f in os.listdir(root):
        if f.endswith(".params"):
            os.remove(os.path.join(root, f))
