"""Entry points of the port: the serving driver (``serve``)."""
