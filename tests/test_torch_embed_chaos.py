"""The embedding plane's SIGKILL chaos lane of the PyTorch port: the JAX
package's `tests/test_embed_chaos.py` run on the port
(`torch_ps_parity.port_copy`), its workers
`tests/torch_embed_chaos_worker.py`.  Marked slow, as the lane it
copies.
"""
import torch_ps_parity as parity

parity.port_copy("test_embed_chaos.py", globals())
