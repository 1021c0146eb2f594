"""Entry points of the port (``serve``: paged-KV LM serving)."""
