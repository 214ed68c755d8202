# FastEWQ's six classifiers (paper §4.4), the scaler and the metrics: numpy
# host code, a copy of the JAX package's, held to it to the bit by
# tests/test_torch_classifiers.py.
