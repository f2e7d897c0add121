"""One module a traffic kind: the code that drives the program for it."""
