"""Generic class-factory registry (reference: python/mxnet/registry.py).

The PyTorch counterpart of ``mxnet_tpu/registry.py``.

`get_register_func` / `get_alias_func` / `get_create_func` build the
register/alias/create triple for a base class, with the reference's
config-string forms: a plain name, a '["name", {kwargs}]' json list, or
a '{"nickname": ..., kwargs}' json dict.
"""
from __future__ import annotations

import json
import warnings

_REGISTRY = {}

__all__ = ["get_registry", "get_register_func", "get_alias_func",
           "get_create_func"]


def _reg_for(base_class):
    return _REGISTRY.setdefault(base_class, {})


def get_registry(base_class):
    """A copy of the name→class mapping registered under base_class."""
    return dict(_reg_for(base_class))


def get_register_func(base_class, nickname):
    registry = _reg_for(base_class)

    def register(klass, name=None):
        assert issubclass(klass, base_class), \
            f"can only register subclasses of {base_class.__name__}"
        name = (name or klass.__name__).lower()
        if name in registry and registry[name] is not klass:
            warnings.warn(
                f"new {nickname} {klass.__module__}.{klass.__name__} "
                f"registered with name {name} overrides existing "
                f"{registry[name].__module__}.{registry[name].__name__}",
                UserWarning, stacklevel=2)
        registry[name] = klass
        return klass

    register.__doc__ = f"Register a {nickname} to the {nickname} factory"
    return register


def get_alias_func(base_class, nickname):
    register = get_register_func(base_class, nickname)

    def alias(*aliases):
        def reg(klass):
            for name in aliases:
                register(klass, name)
            return klass

        return reg

    return alias


def get_create_func(base_class, nickname):
    registry = _reg_for(base_class)

    def create(*args, **kwargs):
        if args:
            name, args = args[0], args[1:]
        else:
            name = kwargs.pop(nickname)
        if isinstance(name, base_class):
            assert not args and not kwargs, \
                f"{nickname} is already an instance"
            return name
        if isinstance(name, dict):
            return create(**name)
        assert isinstance(name, str), f"{nickname} must be a string"
        if name.startswith("["):
            assert not args and not kwargs
            name, kwargs = json.loads(name)
            return create(name, **kwargs)
        if name.startswith("{"):
            assert not args and not kwargs
            return create(**json.loads(name))
        name = name.lower()
        assert name in registry, \
            f"{name} is not registered; register with {nickname}.register"
        return registry[name](*args, **kwargs)

    create.__doc__ = f"Create a {nickname} instance from config"
    return create
