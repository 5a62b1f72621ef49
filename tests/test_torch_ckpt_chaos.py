"""The real-SIGKILL checkpoint chaos lane of the PyTorch port: the JAX
package's `tests/test_ckpt_chaos.py` run on the port
(`torch_ps_parity.port_copy`), its worker `tests/torch_ckpt_chaos_
worker.py` (killed inside the save window; the previous checkpoint
survives and the restart ends bit-equal).  Marked slow, as the lane it
copies.
"""
import torch_ps_parity as parity

parity.port_copy("test_ckpt_chaos.py", globals())
