"""Model definitions: config, dense decoder, router encoder."""
