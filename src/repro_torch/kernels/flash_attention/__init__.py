"""Flash attention (prefill): wrapper (``ops``) and plain version
(``ref``)."""
