"""One module per entry point of the program that a traffic mix drives."""
