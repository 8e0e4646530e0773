"""The port's commands (``delta_tpu.commands``): the table writer, ALTER TABLE
SET TBLPROPERTIES and MERGE; ``delta_tpu_torch`` exports the entry points."""
