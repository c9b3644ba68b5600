"""Architecture configs the port runs (see ``registry``)."""
