"""Plain PyTorch references of the benchmark's configurations.

Each configuration's equations (one module per system, named by the
configuration file's ``reference`` key) and the multi-stage collocation
transcription (:mod:`.ocp`) are written out again here from do-mpc's
examples, independent of the port: nothing in this package imports
``dompc_tpu_torch``.  :mod:`.kkt` judges a returned solution by its KKT
error in float64.
"""
