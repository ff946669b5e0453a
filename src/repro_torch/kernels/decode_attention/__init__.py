"""Dense-cache GQA decode attention: wrappers (``ops``) and plain version
(``ref``)."""
