"""Entry points of the port (``serve``: paged-KV LM serving; ``mesh``:
the (data, model) meshes of device slots the SPMD engine runs over)."""
