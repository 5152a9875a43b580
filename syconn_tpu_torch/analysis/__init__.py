"""Analysis after the export (counterpart of ``syconn_tpu/analysis/``): the
REST server, its viewer client and the biology interface; host code."""
