"""One module per model family (``model_type``): ``arch(cfg) -> Arch``."""
