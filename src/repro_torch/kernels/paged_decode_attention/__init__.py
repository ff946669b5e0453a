"""Paged GQA decode attention: wrapper (``ops``) and plain version
(``ref``)."""
