"""update_ms_per_step.insert: the build's graph update (core/builder.py
``insert_step``: prune, neighbor writes, reciprocal rounds, in-link
guarantee, refresh). The mean host length of the program's ``insert.step``
spans less their ``insert.store`` and ``insert.candidates`` children, per
step of the traced ``Coordinator.insert`` calls, in ms."""

from lmdbench import spans


def read(run):
    split = spans.per_step_ms(run)
    return None if split is None else split["update"]
