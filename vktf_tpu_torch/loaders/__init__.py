"""Scene structures and decoded textures (the glTF/KTX file loaders are not
ported yet)."""
