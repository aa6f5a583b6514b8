"""launches_per_render (count): the device operations (kernels, copies,
sets) in the profiled slice, per render."""


def read(run):
    sl = run.slice
    return len(sl.device_ops) / sl.renders if sl and sl.device_ops else None
