"""Vision model zoo (reference:
python/mxnet/gluon/model_zoo/vision/__init__.py get_model:91; the JAX
package's ``mxnet_tpu/gluon/model_zoo/vision/__init__.py:19-35``): ResNet
V1 and V2, AlexNet, VGG with and without batch norm, SqueezeNet,
MobileNet v1 and v2, DenseNet and Inception v3. ``pretrained=True``
loads a weight file from the model store (``model_store.py``)."""
from . import alexnet as _alexnet
from . import densenet as _densenet
from . import inception as _inception
from . import mobilenet as _mobilenet
from . import resnet as _resnet
from . import squeezenet as _squeezenet
from . import vgg as _vgg
from .alexnet import *  # noqa: F401,F403
from .densenet import *  # noqa: F401,F403
from .inception import *  # noqa: F401,F403
from .mobilenet import *  # noqa: F401,F403
from .resnet import *  # noqa: F401,F403
from .squeezenet import *  # noqa: F401,F403
from .vgg import *  # noqa: F401,F403

_models = {}
for _mod in (_resnet, _alexnet, _vgg, _squeezenet, _mobilenet, _densenet,
             _inception):
    for _name in _mod.__all__:
        _obj = getattr(_mod, _name)
        if callable(_obj) and _name[0].islower() and \
                not _name.startswith("get_"):
            _models[_name] = _obj


def get_model(name, **kwargs):
    """The zoo model ``name`` built with ``kwargs`` (reference:
    vision/__init__.py:91)."""
    name = name.lower()
    if name not in _models:
        raise ValueError(
            f"Model {name} is not supported. Available: {sorted(_models)}")
    return _models[name](**kwargs)
