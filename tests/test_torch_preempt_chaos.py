"""The real-signal preemption chaos lane of the PyTorch port: the JAX
package's `tests/test_preempt_chaos.py` run on the port
(`torch_ps_parity.port_copy`), its workers `tests/torch_preempt_chaos_
worker.py` (a real SIGTERM mid-epoch: exit 75, a committed mid-epoch
checkpoint, a bit-equal resume; a supervised worker SIGKILLed and
respawned under a fresh identity).  Marked slow, as the lane it copies.
"""
import torch_ps_parity as parity

parity.port_copy("test_preempt_chaos.py", globals())
