"""Requests a coalesced serving call: MicroBatcher.items_served over
.batches_run across the traced window (serve-256-f32-sat)."""


def read(w):
    calls = w.counters.get("batches_run", 0)
    return w.counters["items_served"] / calls if calls else None
