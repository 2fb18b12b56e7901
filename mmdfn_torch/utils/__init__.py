"""Helpers the models share."""
