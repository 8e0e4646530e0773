"""The port's transactions (``delta_tpu.txn``): the optimistic transaction,
the conflict checker and the isolation levels."""
