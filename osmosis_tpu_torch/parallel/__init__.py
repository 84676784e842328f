"""Batched (fleet) execution of the guided chain on one card."""
