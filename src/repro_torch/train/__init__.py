"""Step functions of the port (serving: one denoise step)."""
