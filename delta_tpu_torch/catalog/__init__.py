"""Part of the delta_tpu_torch port; mirrors the delta_tpu subpackage of the same name."""
