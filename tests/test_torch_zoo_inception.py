"""Inception-v3 whole at 299 x 299 through the port's Gluon against the
JAX package's, on the CPU: `tests/test_torch_zoo.py`'s family check
(predict-mode and train-mode forwards, one gradient step), in a file of
its own so that it runs beside the other families."""
from test_torch_zoo import check_family


def test_inception_v3_matches_reference():
    check_family("inceptionv3")
