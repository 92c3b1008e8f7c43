/* dlopen-based HDF5 access for PacBio .bax.h5 ingest.
 *
 * The environment ships libhdf5_serial.so.103 without development headers,
 * so the needed 1.8-era API surface (stable since HDF5 1.8.7, which is what
 * the reference links against — Makefile:12-13) is declared here and
 * resolved at runtime with dlopen/dlsym.  Covers exactly what the
 * reference's bax reader touches (bax.c:139-274): bulk H5Dread of the
 * BaseCalls datasets, ZMW tables, Regions, and the MovieName / BaseMap
 * string attributes — plus writer entry points used to create test
 * fixtures (the environment has no h5py).
 *
 * Build: gcc -O2 -shared -fPIC hdf5_shim.c -o _hdf5_shim.so -ldl
 */

#include <dlfcn.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

typedef long long   hid_t_;
typedef int         herr_t_;
typedef unsigned long long hsize_t_;

#define H5F_ACC_RDONLY 0u
#define H5F_ACC_TRUNC  2u
#define H5P_DEFAULT    0
#define H5S_ALL        0
#define H5E_DEFAULT    0
#define H5S_SCALAR     0
#define H5T_VARIABLE   ((size_t) -1)

static void *lib = NULL;

static herr_t_ (*p_H5open)(void);
static herr_t_ (*p_H5Eset_auto2)(hid_t_, void *, void *);
static hid_t_  (*p_H5Fopen)(const char *, unsigned, hid_t_);
static hid_t_  (*p_H5Fcreate)(const char *, unsigned, hid_t_, hid_t_);
static herr_t_ (*p_H5Fclose)(hid_t_);
static hid_t_  (*p_H5Dopen2)(hid_t_, const char *, hid_t_);
static hid_t_  (*p_H5Dcreate2)(hid_t_, const char *, hid_t_, hid_t_, hid_t_, hid_t_, hid_t_);
static hid_t_  (*p_H5Dget_space)(hid_t_);
static herr_t_ (*p_H5Dread)(hid_t_, hid_t_, hid_t_, hid_t_, hid_t_, void *);
static herr_t_ (*p_H5Dwrite)(hid_t_, hid_t_, hid_t_, hid_t_, hid_t_, const void *);
static herr_t_ (*p_H5Dclose)(hid_t_);
static int     (*p_H5Sget_simple_extent_dims)(hid_t_, hsize_t_ *, hsize_t_ *);
static hid_t_  (*p_H5Screate_simple)(int, const hsize_t_ *, const hsize_t_ *);
static hid_t_  (*p_H5Screate)(int);
static herr_t_ (*p_H5Sclose)(hid_t_);
static hid_t_  (*p_H5Gopen2)(hid_t_, const char *, hid_t_);
static hid_t_  (*p_H5Gcreate2)(hid_t_, const char *, hid_t_, hid_t_, hid_t_);
static herr_t_ (*p_H5Gclose)(hid_t_);
static hid_t_  (*p_H5Aopen)(hid_t_, const char *, hid_t_);
static hid_t_  (*p_H5Acreate2)(hid_t_, const char *, hid_t_, hid_t_, hid_t_, hid_t_);
static herr_t_ (*p_H5Aread)(hid_t_, hid_t_, void *);
static herr_t_ (*p_H5Awrite)(hid_t_, hid_t_, const void *);
static hid_t_  (*p_H5Aget_type)(hid_t_);
static hid_t_  (*p_H5Aget_space)(hid_t_);
static herr_t_ (*p_H5Aclose)(hid_t_);
static hid_t_  (*p_H5Tcopy)(hid_t_);
static herr_t_ (*p_H5Tset_size)(hid_t_, size_t);
static size_t  (*p_H5Tget_size)(hid_t_);
static int     (*p_H5Tis_variable_str)(hid_t_);
static herr_t_ (*p_H5Tclose)(hid_t_);
static herr_t_ (*p_H5free_memory)(void *);

static hid_t_ t_uchar, t_ushort, t_int, t_float, t_cs1;

#define RESOLVE(name)                                            \
  do { p_##name = dlsym(lib, #name);                             \
       if (p_##name == NULL) return -1; } while (0)

int dxt_h5_init(const char *libpath)
{ hid_t_ *g;

  if (lib != NULL)
    return 0;
  lib = dlopen(libpath && libpath[0] ? libpath : "libhdf5_serial.so.103",
               RTLD_NOW | RTLD_GLOBAL);
  if (lib == NULL)
    lib = dlopen("libhdf5_serial.so", RTLD_NOW | RTLD_GLOBAL);
  if (lib == NULL)
    lib = dlopen("libhdf5.so", RTLD_NOW | RTLD_GLOBAL);
  if (lib == NULL)
    return -1;

  RESOLVE(H5open);            RESOLVE(H5Eset_auto2);
  RESOLVE(H5Fopen);           RESOLVE(H5Fcreate);      RESOLVE(H5Fclose);
  RESOLVE(H5Dopen2);          RESOLVE(H5Dcreate2);     RESOLVE(H5Dget_space);
  RESOLVE(H5Dread);           RESOLVE(H5Dwrite);       RESOLVE(H5Dclose);
  RESOLVE(H5Sget_simple_extent_dims);
  RESOLVE(H5Screate_simple);  RESOLVE(H5Screate);      RESOLVE(H5Sclose);
  RESOLVE(H5Gopen2);          RESOLVE(H5Gcreate2);     RESOLVE(H5Gclose);
  RESOLVE(H5Aopen);           RESOLVE(H5Acreate2);     RESOLVE(H5Aread);
  RESOLVE(H5Awrite);          RESOLVE(H5Aget_type);    RESOLVE(H5Aget_space);
  RESOLVE(H5Aclose);
  RESOLVE(H5Tcopy);           RESOLVE(H5Tset_size);    RESOLVE(H5Tget_size);
  RESOLVE(H5Tis_variable_str); RESOLVE(H5Tclose);
  p_H5free_memory = dlsym(lib, "H5free_memory");   /* optional */

  if (p_H5open() < 0)
    return -1;
  p_H5Eset_auto2(H5E_DEFAULT, NULL, NULL);

#define GLOBAL(var, sym)                                         \
  do { g = dlsym(lib, sym); if (g == NULL) return -1; var = *g; } while (0)
  GLOBAL(t_uchar,  "H5T_NATIVE_UCHAR_g");
  GLOBAL(t_ushort, "H5T_NATIVE_USHORT_g");
  GLOBAL(t_int,    "H5T_NATIVE_INT_g");
  GLOBAL(t_float,  "H5T_NATIVE_FLOAT_g");
  GLOBAL(t_cs1,    "H5T_C_S1_g");
  return 0;
}

static hid_t_ code_type(int code)
{ switch (code)
  { case 0: return t_uchar;
    case 1: return t_ushort;
    case 2: return t_int;
    case 3: return t_float;
  }
  return -1;
}

long long dxt_h5_open(const char *path)
{ return p_H5Fopen(path, H5F_ACC_RDONLY, H5P_DEFAULT); }

void dxt_h5_close(long long f)
{ p_H5Fclose(f); }

/* Return the rank (or -1) and fill dims[0..rank) for a dataset. */
int dxt_h5_dataset_dims(long long f, const char *path, long long *dims, int maxrank)
{ hid_t_  dset, space;
  hsize_t_ hdims[8];
  int     rank, i;

  dset = p_H5Dopen2(f, path, H5P_DEFAULT);
  if (dset < 0)
    return -1;
  space = p_H5Dget_space(dset);
  if (space < 0)
    { p_H5Dclose(dset); return -1; }
  rank = p_H5Sget_simple_extent_dims(space, hdims, NULL);
  p_H5Sclose(space);
  p_H5Dclose(dset);
  if (rank < 0 || rank > maxrank)
    return -1;
  for (i = 0; i < rank; i++)
    dims[i] = (long long) hdims[i];
  return rank;
}

/* Bulk-read a whole dataset into buf as the given native type code. */
int dxt_h5_read(long long f, const char *path, int code, void *buf)
{ hid_t_ dset;
  herr_t_ stat;

  dset = p_H5Dopen2(f, path, H5P_DEFAULT);
  if (dset < 0)
    return -1;
  stat = p_H5Dread(dset, code_type(code), H5S_ALL, H5S_ALL, H5P_DEFAULT, buf);
  p_H5Dclose(dset);
  return stat < 0 ? -1 : 0;
}

/* Read a string attribute on a group (variable or fixed length). */
int dxt_h5_attr_str(long long f, const char *grp, const char *attr,
                    char *out, int cap)
{ hid_t_ g, a, type;
  int    vl, n = -1;

  g = p_H5Gopen2(f, grp, H5P_DEFAULT);
  if (g < 0)
    return -1;
  a = p_H5Aopen(g, attr, H5P_DEFAULT);
  if (a < 0)
    { p_H5Gclose(g); return -1; }
  type = p_H5Aget_type(a);
  if (type < 0)
    { p_H5Aclose(a); p_H5Gclose(g); return -1; }
  vl = p_H5Tis_variable_str(type);
  if (vl > 0)
    { char *name = NULL;
      if (p_H5Aread(a, type, &name) >= 0 && name != NULL)
        { n = (int) strlen(name);
          if (n >= cap) n = cap - 1;
          memcpy(out, name, n);
          out[n] = '\0';
          if (p_H5free_memory) p_H5free_memory(name); else free(name);
        }
    }
  else
    { size_t sz = p_H5Tget_size(type);
      if ((int) sz < cap && p_H5Aread(a, type, out) >= 0)
        { out[sz] = '\0';
          n = (int) strnlen(out, sz);
        }
    }
  p_H5Tclose(type);
  p_H5Aclose(a);
  p_H5Gclose(g);
  return n;
}

/* ------------------------------------------------------------------ */
/* writer half: used to create synthetic .bax.h5 test fixtures         */
/* ------------------------------------------------------------------ */

long long dxt_h5_create(const char *path)
{ return p_H5Fcreate(path, H5F_ACC_TRUNC, H5P_DEFAULT, H5P_DEFAULT); }

static hid_t_ ensure_groups(hid_t_ f, const char *path, char *leaf, int cap)
{ /* create intermediate groups of "path" (a dataset path); copy the final
     component into leaf and return the parent group id (caller closes). */
  char buf[512];
  char *p, *q;
  hid_t_ cur, nxt;

  strncpy(buf, path, sizeof(buf) - 1);
  buf[sizeof(buf) - 1] = '\0';
  q = strrchr(buf, '/');
  if (q == NULL)
    return -1;
  strncpy(leaf, q + 1, cap - 1);
  leaf[cap - 1] = '\0';
  *q = '\0';

  cur = p_H5Gopen2(f, "/", H5P_DEFAULT);
  if (buf[0] == '\0')            /* top-level dataset: parent is the root */
    return cur;
  for (p = buf + 1; *p != '\0' && cur >= 0; )
    { char *s = strchr(p, '/');
      if (s != NULL)
        *s = '\0';
      nxt = p_H5Gopen2(cur, p, H5P_DEFAULT);
      if (nxt < 0)
        nxt = p_H5Gcreate2(cur, p, H5P_DEFAULT, H5P_DEFAULT, H5P_DEFAULT);
      p_H5Gclose(cur);
      cur = nxt;
      if (s == NULL)
        break;
      p = s + 1;
    }
  return cur;
}

int dxt_h5_write(long long f, const char *path, int code,
                 const void *buf, const long long *dims, int rank)
{ hid_t_  grp, space, dset;
  hsize_t_ hdims[8];
  char    leaf[256];
  int     i;
  herr_t_ stat;

  grp = ensure_groups(f, path, leaf, sizeof(leaf));
  if (grp < 0)
    return -1;
  for (i = 0; i < rank; i++)
    hdims[i] = (hsize_t_) dims[i];
  space = p_H5Screate_simple(rank, hdims, NULL);
  dset = p_H5Dcreate2(grp, leaf, code_type(code), space,
                      H5P_DEFAULT, H5P_DEFAULT, H5P_DEFAULT);
  if (dset < 0)
    { p_H5Sclose(space); p_H5Gclose(grp); return -1; }
  stat = p_H5Dwrite(dset, code_type(code), H5S_ALL, H5S_ALL, H5P_DEFAULT, buf);
  p_H5Dclose(dset);
  p_H5Sclose(space);
  p_H5Gclose(grp);
  return stat < 0 ? -1 : 0;
}

int dxt_h5_attr_str_write(long long f, const char *grp_path, const char *attr,
                          const char *value)
{ char  leaf[256];
  char  full[512];
  hid_t_ grp, type, space, a;
  herr_t_ stat;

  /* ensure the group chain exists (grp_path is a group, add dummy leaf) */
  snprintf(full, sizeof(full), "%s/_", grp_path);
  grp = ensure_groups(f, full, leaf, sizeof(leaf));
  if (grp < 0)
    return -1;

  type = p_H5Tcopy(t_cs1);
  p_H5Tset_size(type, H5T_VARIABLE);
  space = p_H5Screate(H5S_SCALAR);
  a = p_H5Acreate2(grp, attr, type, space, H5P_DEFAULT, H5P_DEFAULT);
  if (a < 0)
    { p_H5Sclose(space); p_H5Tclose(type); p_H5Gclose(grp); return -1; }
  stat = p_H5Awrite(a, type, &value);
  p_H5Aclose(a);
  p_H5Sclose(space);
  p_H5Tclose(type);
  p_H5Gclose(grp);
  return stat < 0 ? -1 : 0;
}
