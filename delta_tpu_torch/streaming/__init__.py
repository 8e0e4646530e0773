"""Structured streaming over Delta tables: the source, the CDF source, the
exactly-once sink and the micro-batch driver (the port's own copy of
``delta_tpu.streaming``)."""
