"""rumba.device_idle_pct: the share of the traced window in which no operation
(kernel, copy, memset) runs on the card, from `torch.profiler`'s device
events (their intervals' union), in %."""


def read(run):
    tr = run.trace
    return 100.0 * (1.0 - tr.busy / tr.window_s)
