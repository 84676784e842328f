"""unet_graph_pct (%, the program's counters): the share of the UNet's calls
(``unet.calls``) that replayed its CUDA graph of the forward
(``unet.graph_replays``), 100 x replays / calls, over every segment the
run's process ran: the warm-up, the window and the traced passes. None
where the program does not count its UNet calls."""


def read(ctx):
    from osmosis_tpu_torch.utils import profiling

    counts = profiling.counters()
    if not counts["unet.calls"]:
        return None
    return 100.0 * counts["unet.graph_replays"] / counts["unet.calls"]
