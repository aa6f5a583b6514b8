"""Plain NumPy references of the renders the cells time; they import
nothing of the program."""
