"""Configurations of the paper's pricing workloads."""
