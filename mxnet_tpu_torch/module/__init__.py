"""The symbolic training workflow (the counterpart of `mxnet_tpu/module`)."""
from .base_module import BaseModule
from .bucketing_module import BucketingModule
from .module import Module
from .python_module import PythonLossModule, PythonModule
from .sequential_module import SequentialModule

__all__ = ["BaseModule", "Module", "BucketingModule", "SequentialModule",
           "PythonModule", "PythonLossModule"]
