"""Architecture configurations: verbatim copies of ``repro.configs``."""
