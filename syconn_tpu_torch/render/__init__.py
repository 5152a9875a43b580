"""Multi-view rendering of cell meshes (counterpart of ``syconn_tpu/render/``)."""
