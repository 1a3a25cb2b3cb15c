"""Vision model zoo (reference:
python/mxnet/gluon/model_zoo/vision/__init__.py get_model:91). The port
has the ResNet V1 family (``resnet{18,34,50,101,152}_v1``); the V2
family and the other zoo families wait (ROADMAP)."""
from . import resnet as _resnet
from .resnet import *  # noqa: F401,F403

_models = {name: getattr(_resnet, name) for name in _resnet.__all__
           if name[0].islower() and not name.startswith("get_")}


def get_model(name, **kwargs):
    """The zoo model ``name`` built with ``kwargs`` (reference:
    vision/__init__.py:91)."""
    name = name.lower()
    if name not in _models:
        raise ValueError(
            f"Model {name} is not supported. Available: {sorted(_models)}")
    return _models[name](**kwargs)
