"""Aggregation core: rules, Bulyan, attacks, flat adapters."""
