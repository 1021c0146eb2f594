"""Entry points of the port (``serve``: paged-KV LM serving; ``train``:
single-device training; ``mesh``: the (data, model) meshes of device
slots the SPMD engine runs over; ``procs``: the process group of the
multi-host entry)."""
