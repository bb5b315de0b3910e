"""Device selection and the flag registry of the port."""
