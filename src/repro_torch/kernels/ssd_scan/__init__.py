"""Mamba-2 SSD intra-chunk scan: wrappers (``ops``) and plain versions
(``ref``)."""
