"""% of rank 0's fit in collectives: the seconds ``DataMesh`` timed (it
synchronises the card around each one) over the ``fit`` stage of a job run
with a timed mesh after the window; nothing on one card."""


def read(run):
    if run.timed is None or not run.timed.stages.get("fit"):
        return None
    spent = sum(rec[2] for rec in run.timed.collectives.values())
    return 100.0 * spent / run.timed.stages["fit"]
