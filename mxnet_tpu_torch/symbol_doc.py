"""Extra-doc attachment for symbolic operators (the counterpart of
`mxnet_tpu/symbol_doc.py`; reference ``python/mxnet/symbol_doc.py``).

Same contract as `ndarray_doc` but for the Symbol
surface, plus the reference's ``get_output_shape`` doc-test helper.
"""
from .ndarray_doc import _build_doc as _nd_build_doc


class SymbolDoc(object):
    """Base class for attaching extra doc to symbolic operators."""

    @staticmethod
    def get_output_shape(sym, **input_shapes):
        """Get user-friendly dict of output shapes given input shapes
        (reference `python/mxnet/symbol_doc.py:56-60`)."""
        _, s_outputs, _ = sym.infer_shape(**input_shapes)
        return dict(zip(sym.list_outputs(), s_outputs))


def _collect_extra_docs():
    docs = {}
    for cls in SymbolDoc.__subclasses__():
        name = cls.__name__
        if name.endswith('Doc'):
            docs[name[:-3]] = cls.__doc__ or ''
    return docs


def _build_doc(func_name, desc, arg_names, arg_types, arg_descs,
               key_var_num_args=None, ret_type=None):
    """Symbol-surface docstring assembly; appends ``<op>Doc`` extras."""
    doc = _nd_build_doc(func_name, desc, arg_names, arg_types, arg_descs,
                        key_var_num_args,
                        ret_type or 'out : Symbol\n    The result symbol.')
    extra = _collect_extra_docs().get(func_name)
    if extra:
        doc += '\n\n' + extra
    return doc
