"""% of the traced mean-field job in which no operation ran on the card:
one less the union of the device's operation intervals over the job's wall,
averaged over the ranks."""


def read(run):
    if run.kind != "mf" or not run.profile or not run.profile["busy_s"]:
        return None
    return 100.0 * (1.0 - run.busy_s / run.profile["window_s"])
