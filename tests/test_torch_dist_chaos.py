"""The multiprocess SIGKILL chaos lane of the PyTorch port's parameter
server: the JAX package's `tests/test_dist_chaos.py` run on the port
(`torch_ps_parity.port_copy`), its workers `tests/torch_ps_chaos_worker.py`.
Marked slow, as the lane it copies.
"""
import torch_ps_parity as parity

parity.port_copy("test_dist_chaos.py", globals())
