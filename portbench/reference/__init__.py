"""The plain float32 reference that the program is held against."""
