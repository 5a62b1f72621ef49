"""Registry for serializable objects (the counterpart of
`mxnet_tpu/registry.py`; ``mx.registry``).

Factory machinery behind string-named, JSON-configurable object families
(initializers, optimizers, lr schedulers...).  Behavior contract from
reference ``python/mxnet/registry.py:30-176``: per-base-class name
registries, override warnings, alias registration, and a ``create``
that accepts an instance (passthrough), a dict, a plain name, or the
two JSON spellings ``'["name", {kwargs}]'`` and ``'{"nickname": ...}'``.
"""
import json
import warnings

_REGISTRY = {}


def get_registry(base_class):
    """Return a copy of the name->class registry for ``base_class``."""
    if base_class not in _REGISTRY:
        _REGISTRY[base_class] = {}
    return _REGISTRY[base_class].copy()


def get_register_func(base_class, nickname):
    """Build a ``register(klass, name=None)`` function for ``base_class``.

    Registered names are lower-cased; re-registering an existing name
    warns (the reference's override warning) but succeeds, so user code
    can shadow built-ins.
    """
    if base_class not in _REGISTRY:
        _REGISTRY[base_class] = {}
    registry = _REGISTRY[base_class]

    def register(klass, name=None):
        if not (isinstance(klass, type) and issubclass(klass, base_class)):
            raise AssertionError(
                "Can only register subclass of %s" % base_class.__name__)
        key = (klass.__name__ if name is None else name).lower()
        if key in registry and registry[key] is not klass:
            warnings.warn(
                "New %s %s.%s registered with name %s is overriding "
                "existing %s %s.%s" % (
                    nickname, klass.__module__, klass.__name__, key,
                    nickname, registry[key].__module__,
                    registry[key].__name__),
                UserWarning, stacklevel=2)
        registry[key] = klass
        return klass

    register.__doc__ = "Register %s to the %s factory" % (nickname, nickname)
    return register


def get_alias_func(base_class, nickname):
    """Build an ``alias('a', 'b')`` decorator registering several names."""
    register = get_register_func(base_class, nickname)

    def alias(*aliases):
        def reg(klass):
            for name in aliases:
                register(klass, name)
            return klass
        return reg
    return alias


def get_create_func(base_class, nickname):
    """Build a ``create`` factory resolving names/dicts/JSON to instances."""
    if base_class not in _REGISTRY:
        _REGISTRY[base_class] = {}
    registry = _REGISTRY[base_class]

    def create(*args, **kwargs):
        if args:
            name, args = args[0], args[1:]
        else:
            name = kwargs.pop(nickname)

        if isinstance(name, base_class):
            if args or kwargs:
                raise AssertionError(
                    "%s is already an instance. Additional arguments are "
                    "invalid" % nickname)
            return name

        if isinstance(name, dict):
            return create(**name)

        if not isinstance(name, str):
            raise AssertionError("%s must be of string type" % nickname)

        if name.startswith('['):
            assert not args and not kwargs
            name, kwargs = json.loads(name)
            return create(name, **kwargs)
        if name.startswith('{'):
            assert not args and not kwargs
            kwargs = json.loads(name)
            return create(**kwargs)

        key = name.lower()
        if key not in registry:
            raise AssertionError(
                "%s is not registered. Please register with %s.register "
                "first" % (name, nickname))
        return registry[key](*args, **kwargs)

    create.__doc__ = ("Create a %s instance from config (name, instance, "
                      "dict, or JSON)." % nickname)
    return create
