"""The port's commands (``delta_tpu.commands``): the table writer, CREATE /
REPLACE / CTAS, MERGE, DELETE, UPDATE, RESTORE, VACUUM, OPTIMIZE, SHALLOW
CLONE, CONVERT TO DELTA, DESCRIBE and ALTER TABLE; ``delta_tpu_torch``
exports the entry points."""
