"""The paper's evaluation models."""
