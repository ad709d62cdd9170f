"""The plain reference the served results are held against."""
