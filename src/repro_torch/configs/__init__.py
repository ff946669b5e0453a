"""Published architecture configs the port serves."""
