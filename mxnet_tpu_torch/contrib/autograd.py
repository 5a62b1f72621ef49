"""The legacy experimental autograd API (the counterpart of
`mxnet_tpu/contrib/autograd.py`; reference
``python/mxnet/contrib/autograd.py``, which predates
``mx.autograd``; old scripts import ``train_section``/``grad_and_loss``
from here).  Everything delegates to the modern tape."""
import functools

from .. import autograd as _ag
from ..ndarray import NDArray
from ..ndarray import zeros as _zeros


def set_is_training(is_train):
    """Set training mode globally; returns the previous state.

    The legacy API had ONE flag covering both recording and train mode;
    here both are set together and the returned previous state is the
    RECORDING flag, so a save/restore round-trip
    (`prev = set_is_training(x); ...; set_is_training(prev)`) preserves
    an enclosing `autograd.record()` scope."""
    prev = _ag.is_recording()
    _ag.set_training(is_train)
    _ag.set_recording(is_train)
    return prev


def train_section():
    """Context: operations are recorded for gradient (the old name for
    ``autograd.record()``)."""
    return _ag.record(train_mode=True)


def test_section():
    """Context: inference mode inside a train_section (the old name for
    ``autograd.pause()``)."""
    return _ag.pause(train_mode=False)


def backward(outputs, out_grads=None, retain_graph=False):
    """Backward over a list of outputs."""
    _ag.backward(outputs, out_grads, retain_graph=retain_graph)


def compute_gradient(outputs):
    """Deprecated alias of :func:`backward`."""
    backward(outputs)


def grad_and_loss(func, argnum=None):
    """Return a function computing (gradients of args, loss) of ``func``
    (reference `contrib/autograd.py:163-193`)."""
    @functools.wraps(func)
    def wrapped(*args):
        variables = args
        if argnum is not None:
            argnum_ = argnum if isinstance(argnum, list) else [argnum]
            variables = [args[i] for i in argnum_]
        for x in variables:
            assert isinstance(x, NDArray), \
                "type of autograd input should NDArray."
        grads = [_zeros(x.shape, dtype=x.dtype) for x in variables]
        _ag.mark_variables(variables, grads)
        with train_section():
            outputs = func(*args)
        compute_gradient([outputs] if isinstance(outputs, NDArray)
                         else outputs)
        return grads, outputs
    return wrapped


def grad(func, argnum=None):
    """Return a function computing gradients of ``func``'s arguments."""
    grad_with_loss_func = grad_and_loss(func, argnum)

    @functools.wraps(grad_with_loss_func)
    def wrapped(*args):
        return grad_with_loss_func(*args)[0]
    return wrapped
