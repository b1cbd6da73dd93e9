"""Result writers of the port (VTK, ExodusII) and the Gmsh reader."""
