"""Routing policies and cost accounting."""
