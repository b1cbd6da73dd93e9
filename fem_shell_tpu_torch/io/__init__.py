"""Result writers of the port (VTK, ExodusII)."""
