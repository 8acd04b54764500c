"""Model code of the port (the GPT language model's serving math)."""
