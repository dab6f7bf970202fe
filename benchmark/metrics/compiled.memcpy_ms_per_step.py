"""compiled.memcpy_ms_per_step: device time of the device-to-device copies
(Memcpy DtoD events of the trace) per step of the traced cycle: the compiled
step's copy-in and clone-out and the while nodes' carry copies
(``solver/compiled.py``). The entry's host copies (the BC upload, the
read-backs) are not in it."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    copies = [e for e in tr.device if e.get("cat") == "gpu_memcpy" and "DtoD" in e["name"]]
    if not copies:
        return None
    return tr.seconds(copies) * 1e3 / ctx["trace_steps"]
