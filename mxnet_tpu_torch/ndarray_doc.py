"""Extra-doc attachment for ndarray operators (the counterpart of
`mxnet_tpu/ndarray_doc.py`; reference ``python/mxnet/ndarray_doc.py``).

To document operator ``XXX`` beyond its registry docstring, define
``class XXXDoc(NDArrayDoc)`` here (or in user code) whose docstring is
the extra text; ``_build_doc`` stitches it into the generated function
doc.  The op codegen (`ndarray/register.py`) builds docstrings from the
registry, so this module's job is the lookup + append contract.
"""


class NDArrayDoc(object):
    """Base class for attaching extra doc to ndarray operators."""


def _collect_extra_docs():
    docs = {}
    for cls in NDArrayDoc.__subclasses__():
        name = cls.__name__
        if name.endswith('Doc'):
            docs[name[:-3]] = cls.__doc__ or ''
    return docs


def _build_doc(func_name, desc, arg_names, arg_types, arg_descs,
               key_var_num_args=None, ret_type=None):
    """Assemble the operator docstring: signature, params, returns, then
    any ``<op>Doc`` subclass docstring appended (reference
    `python/mxnet/ndarray_doc.py:132-155`)."""
    params = '\n'.join('%s : %s\n    %s' % (n, t, d) for n, t, d in
                       zip(arg_names, arg_types, arg_descs))
    doc = '%s\n\nParameters\n----------\n%s\n' % (desc, params)
    doc += '\nReturns\n-------\n%s\n    The output of this function.' % (
        ret_type or 'out : NDArray or list of NDArrays')
    extra = _collect_extra_docs().get(func_name)
    if extra:
        doc += '\n\n' + extra
    return doc
