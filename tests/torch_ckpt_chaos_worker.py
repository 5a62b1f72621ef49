"""Training worker of the PyTorch port for `tests/test_torch_ckpt_chaos.py`
(the counterpart of `tests/ckpt_chaos_worker.py`): the example MLP fit
with the MXTPU_CKPT_DIR auto-resume path, its final arg params dumped to
``CKPT_OUT`` (npz).  The parent SIGKILLs one instance inside the save
window, reruns it to completion and compares against an uninterrupted
run bit for bit.

Env: CKPT_EPOCHS, CKPT_OUT (plus MXTPU_CKPT_DIR/MXTPU_CKPT_COMMIT_DELAY
set by the parent).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

import torch_chaos_mlp as M  # noqa: E402


def main():
    assert "jax" not in sys.modules and "mxnet_tpu" not in sys.modules
    epochs = int(os.environ["CKPT_EPOCHS"])
    out = os.environ["CKPT_OUT"]

    def progress(epoch, sym=None, arg=None, aux=None):
        print(f"CKPT-EPOCH {epoch}", flush=True)

    mod = M.fit(epochs, epoch_end_callback=progress)
    arg, _ = mod.get_params()
    np.savez(out, **{k: v.asnumpy() for k, v in arg.items()})
    print("CKPT-DONE", flush=True)


if __name__ == "__main__":
    main()
