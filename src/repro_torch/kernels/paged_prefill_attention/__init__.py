"""Paged GQA chunked-prefill attention: wrapper (``ops``) and plain
version (``ref``)."""
