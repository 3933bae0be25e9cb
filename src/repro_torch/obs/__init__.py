"""Train-step metrics schema."""
