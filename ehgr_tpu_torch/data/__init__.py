"""Host data layer of the port (counterpart of ``ehgr_tpu/data``)."""
