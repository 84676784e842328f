"""phi_fit_k5_pct (%, the program's counters): the share of the guided steps
with phi-only iterations (``guided.phi_fits``) whose iterations kernel K5 ran
in one launch (``guided.phi_fits_k5``), over every segment the run's process
ran: the warm-up, the window and the traced passes. None where the program
does not count its phi fits."""


def read(ctx):
    from osmosis_tpu_torch.utils import profiling

    counts = profiling.counters()
    if not counts["guided.phi_fits"]:
        return None
    return 100.0 * counts["guided.phi_fits_k5"] / counts["guided.phi_fits"]
