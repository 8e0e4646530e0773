"""Part of the delta_tpu_torch port; mirrors the delta_tpu subpackage of the same name: the
link cost model of the auto router (``link``), the 1-D state mesh and its collectives
(``mesh``), and the host work partitioner (``distributed``)."""
