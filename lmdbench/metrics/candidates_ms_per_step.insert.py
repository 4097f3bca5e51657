"""candidates_ms_per_step.insert: the build's candidate search
(core/builder.py ``insert_step``). The mean host length of the program's
``insert.candidates`` spans per ``insert.step`` in the traced
``Coordinator.insert`` calls, in ms."""

from lmdbench import spans


def read(run):
    split = spans.per_step_ms(run)
    return None if split is None else split["candidates"]
